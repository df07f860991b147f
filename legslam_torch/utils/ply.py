"""Binary PLY save/load for the Gaussian map (tinyply/C19 equivalent).

A copy of legslam_tpu/utils/ply.py.

Vertex property schema matches the reference exactly so the eval stacks
interoperate (src/gaussian_model.cpp:972-1075, eval/gaussian_model.py:59-111):

  x y z  nx ny nz  f_dc_0..2  f_rest_0..44  lf_0..63  opacity
  scale_0..2  rot_0..3    (all float32, binary_little_endian)

f_rest is stored feature-major like the reference: the torch layout is
[N, 15, 3] transposed to [N, 3, 15] then flattened, i.e. channel-major
(f_rest_{c*15+k} = coeff k of channel c).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from legslam_torch.config import LF_CHANNELS, SH_COEFFS_MAX

N_REST = (SH_COEFFS_MAX - 1) * 3  # 45


def _property_names() -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(N_REST)]
    names += [f"lf_{i}" for i in range(LF_CHANNELS)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(path: str, xyz: np.ndarray, f_dc: np.ndarray,
                      f_rest: np.ndarray, lang_feat: np.ndarray,
                      opacity: np.ndarray, scaling: np.ndarray,
                      rotation: np.ndarray) -> None:
    """Write raw (pre-activation) parameters of the VALID gaussians.

    Shapes: xyz [N,3], f_dc [N,1,3], f_rest [N,15,3], lang_feat [N,LF],
    opacity [N,1] raw, scaling [N,3] log, rotation [N,4] raw.
    """
    n = xyz.shape[0]
    xyz = np.asarray(xyz, np.float32)
    normals = np.zeros((n, 3), np.float32)
    dc = np.asarray(f_dc, np.float32).reshape(n, -1)           # [N,3]
    rest = np.asarray(f_rest, np.float32).transpose(0, 2, 1).reshape(n, -1)
    lf = np.asarray(lang_feat, np.float32).reshape(n, -1)
    op = np.asarray(opacity, np.float32).reshape(n, 1)
    sc = np.asarray(scaling, np.float32).reshape(n, 3)
    rot = np.asarray(rotation, np.float32).reshape(n, 4)
    data = np.concatenate([xyz, normals, dc, rest, lf, op, sc, rot], axis=1)

    names = _property_names()
    assert data.shape[1] == len(names)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def load_gaussian_ply(path: str) -> dict:
    """Read a gaussian PLY (ours or the reference's). Returns dict with keys
    xyz, f_dc [N,1,3], f_rest [N,15,3], lang_feat, opacity [N,1],
    scaling [N,3], rotation [N,4] (raw, pre-activation)."""
    with open(path, "rb") as f:
        props: list[Tuple[str, str]] = []
        n = 0
        fmt = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, dtype, name = line.split()
                props.append((name, dtype))
            elif line == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        type_map = {"float": "<f4", "double": "<f8", "uchar": "u1",
                    "int": "<i4", "uint": "<u4"}
        dt = np.dtype([(name, type_map[d]) for name, d in props])
        raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)

    def cols(names):
        return np.stack([raw[nm].astype(np.float32) for nm in names], axis=1)

    n_rest = len([nm for nm, _ in props if nm.startswith("f_rest_")])
    n_lf = len([nm for nm, _ in props if nm.startswith("lf_")])
    out = {
        "xyz": cols(["x", "y", "z"]),
        "f_dc": cols([f"f_dc_{i}" for i in range(3)])[:, None, :],
        "opacity": raw["opacity"].astype(np.float32)[:, None],
        "scaling": cols([f"scale_{i}" for i in range(3)]),
        "rotation": cols([f"rot_{i}" for i in range(4)]),
    }
    rest = cols([f"f_rest_{i}" for i in range(n_rest)])
    out["f_rest"] = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    if n_lf:
        out["lang_feat"] = cols([f"lf_{i}" for i in range(n_lf)])
    else:
        out["lang_feat"] = np.zeros((n, LF_CHANNELS), np.float32)
    return out


def save_point_ply(path: str, xyz: np.ndarray,
                   colors: np.ndarray | None = None) -> None:
    """Sparse input.ply (x y z [r g b uchar]) like GaussianScene's cached
    points export (gaussian_mapper.cpp savePly input.ply)."""
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        dt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.zeros(n, dtype=np.dtype(dt))
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if colors is not None:
        c8 = np.clip(colors * 255.0 if colors.dtype.kind == "f" else colors,
                     0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())
