"""legslam_torch's host-side satellites of the system loop against the
JAX package's, on the CPU: the eval metrics (numpy, exact), checkpoints
written by either package loading in the other, the PLY resume, the
ScanNet .sens reader, the offline trainer's checkpoint, the synthetic
dataset's preload, and the runtime helpers."""
import json
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_torch.eval_harness import metrics as TM
from legslam_torch.mapper import checkpoint as TC
from legslam_torch.models import gaussians as TG
from legslam_tpu.eval_harness import metrics as JM
from legslam_tpu.mapper import checkpoint as JC
from legslam_tpu.models import gaussians as JG
from tests.test_torch_app import replica_scene  # noqa: F401 (fixture)
from tests.torch_parity import jax_state_tree

torch.set_num_threads(1)


# --- metrics -----------------------------------------------------------

def _metric_cases(rng):
    src = rng.normal(size=(50, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    dst = 1.7 * (q @ src.T).T + [0.3, -1.0, 2.0] + \
        rng.normal(scale=0.01, size=(50, 3))
    depth_gt = rng.uniform(0.0, 4.0, size=(12, 16))
    depth_gt[depth_gt < 0.5] = 0.0
    depth_pred = depth_gt + rng.normal(scale=0.02, size=depth_gt.shape)
    gt = rng.integers(0, 6, size=(20, 30))
    pred = np.where(rng.uniform(size=gt.shape) < 0.7, gt,
                    rng.integers(0, 7, size=gt.shape))
    lf = rng.normal(size=(6, 7, 16)).astype(np.float32)
    text = rng.normal(size=(4, 16)).astype(np.float32)
    return {
        "umeyama_alignment": lambda M: M.umeyama_alignment(src, dst),
        "umeyama_no_scale": lambda M: M.umeyama_alignment(src, dst, False),
        "ate_rmse": lambda M: M.ate_rmse(src, dst),
        "depth_l1_cm": lambda M: M.depth_l1_cm(depth_pred, depth_gt),
        "depth_l1_cm_empty": lambda M: M.depth_l1_cm(depth_pred,
                                                     0 * depth_gt),
        "confusion_matrix": lambda M: M.confusion_matrix(pred, gt, 6),
        "miou_from_confusion": lambda M: M.miou_from_confusion(
            M.confusion_matrix(pred, gt, 6), ignore=(0,)),
        "segment_prediction": lambda M: M.segment_prediction(
            lf, text, reject_threshold=0.55),
        "label_sets": lambda M: (M.SCANNET20, M.COCOMAP),
    }


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [x]


@pytest.mark.parametrize("name", list(_metric_cases(
    np.random.default_rng(0))))
def test_metrics_match_jax(name):
    got = _metric_cases(np.random.default_rng(21))[name](TM)
    want = _metric_cases(np.random.default_rng(21))[name](JM)
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str):
            assert x == y
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_lpips_raises_until_ported():
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.lpips_alex(img, img)


# --- checkpoints ---------------------------------------------------------

def _seeded_state(rng, capacity=256, n=180):
    """A JAX GaussianState with every array nonzero: params from a point
    cloud, then random Adam moments, stats and counters."""
    st = JG.create_from_pcd(rng.normal(size=(n, 3)).astype(np.float32),
                            rng.uniform(size=(n, 3)).astype(np.float32),
                            capacity)
    tree = jax_state_tree(st)
    for group in ("adam_m", "adam_v"):
        for k, v in tree[group].items():
            tree[group][k] = rng.normal(size=v.shape).astype(np.float32)
    for k, v in tree["stats"].items():
        tree["stats"][k] = rng.uniform(size=v.shape).astype(np.float32)
    tree["exist_since"] = rng.integers(0, 99, size=capacity) \
        .astype(np.int32)
    tree["adam_step"] = np.asarray(17, np.int32)
    tree["overflow_dropped"] = np.asarray(3, np.int32)
    return tree


def _assert_tree_equal(a, b):
    for key in ("params", "adam_m", "adam_v", "stats"):
        assert sorted(a[key]) == sorted(b[key])
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k],
                                          err_msg=f"{key}/{k}")
    for key in ("valid", "exist_since", "adam_step", "overflow_dropped"):
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_checkpoint_jax_to_torch(tmp_path):
    tree = _seeded_state(np.random.default_rng(22))
    path = str(tmp_path / "jax.npz")
    JC.save_checkpoint(path, JG.GaussianState(**_jax_fields(tree)),
                       meta=dict(it=5))
    st, meta = TC.load_checkpoint(path, device="cpu")
    assert meta == dict(it=5)
    _assert_tree_equal(TG.state_to_numpy(st), tree)


def _jax_fields(tree):
    def p(d):
        return JG.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    return dict(params=p(tree["params"]), adam_m=p(tree["adam_m"]),
                adam_v=p(tree["adam_v"]), valid=jnp.asarray(tree["valid"]),
                exist_since=jnp.asarray(tree["exist_since"]),
                adam_step=jnp.asarray(tree["adam_step"]),
                stats=JG.DensifyStats(**{k: jnp.asarray(v) for k, v in
                                         tree["stats"].items()}),
                overflow_dropped=jnp.asarray(tree["overflow_dropped"]))


def test_checkpoint_torch_to_jax(tmp_path):
    tree = _seeded_state(np.random.default_rng(23))
    st = TG.state_from_numpy(tree, device="cpu")
    path = str(tmp_path / "torch.npz")
    TC.save_checkpoint(path, st, meta=dict(iterations=9))
    jst, meta = JC.load_checkpoint(path)
    assert meta == dict(iterations=9)
    _assert_tree_equal(jax_state_tree(jst), tree)
    # and the port reads its own file back
    back, _ = TC.load_checkpoint(path, device="cpu")
    _assert_tree_equal(TG.state_to_numpy(back), tree)


def test_state_from_ply_matches_jax(tmp_path):
    from legslam_torch.utils.ply import save_gaussian_ply
    tree = _seeded_state(np.random.default_rng(24), capacity=256, n=180)
    p = {k: v[:180] for k, v in tree["params"].items()}
    path = str(tmp_path / "point_cloud.ply")
    save_gaussian_ply(path, p["xyz"], p["f_dc"], p["f_rest"],
                      p["lang_feat"], p["opacity"], p["scaling"],
                      p["rotation"])
    got = TG.state_to_numpy(TC.state_from_ply(path, 300, device="cpu"))
    want = jax_state_tree(JC.state_from_ply(path, 300))
    _assert_tree_equal(got, want)
    assert got["valid"].sum() == 180
    with pytest.raises(ValueError, match="capacity"):
        TC.state_from_ply(path, 100, device="cpu")


# --- ScanNet .sens ---------------------------------------------------------

def _write_sens(path, rng, n_frames=3, h=8, w=12):
    """A tiny version-4 .sens file (jpeg color, zlib depth), the byte
    layout tests/test_aux_components.py writes."""
    import cv2
    frames = []
    with open(path, "wb") as f:
        f.write(struct.pack("I", 4))
        name = b"synthetic"
        f.write(struct.pack("Q", len(name)))
        f.write(name)
        for _ in range(4):
            f.write(rng.normal(size=(4, 4)).astype(np.float32).tobytes())
        f.write(struct.pack("i", 2))   # jpeg color
        f.write(struct.pack("i", 1))   # zlib_ushort depth
        f.write(struct.pack("II", w, h))
        f.write(struct.pack("II", w, h))
        f.write(struct.pack("f", 1000.0))
        f.write(struct.pack("Q", n_frames))
        for i in range(n_frames):
            depth = rng.integers(100, 5000, (h, w)).astype(np.uint16)
            color = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
            _, jpg = cv2.imencode(".jpg", color)
            pose = rng.normal(size=(4, 4)).astype(np.float32)
            dz = zlib.compress(depth.tobytes())
            f.write(pose.tobytes())
            f.write(struct.pack("QQ", 10 * i, 10 * i + 1))
            f.write(struct.pack("QQ", len(jpg.tobytes()), len(dz)))
            f.write(jpg.tobytes())
            f.write(dz)
            frames.append(depth)
    return frames


def test_sens_reader_matches_jax(tmp_path):
    from legslam_torch.data import scannet_sens as TS
    from legslam_tpu.data import scannet_sens as JS
    path = str(tmp_path / "scene.sens")
    depths = _write_sens(path, np.random.default_rng(25))
    with TS.SensReader(path) as a, JS.SensReader(path) as b:
        for attr in ("sensor_name", "color_compression", "depth_compression",
                     "color_width", "color_height", "depth_width",
                     "depth_height", "depth_shift", "num_frames"):
            assert getattr(a, attr) == getattr(b, attr), attr
        for attr in ("intrinsic_color", "extrinsic_color",
                     "intrinsic_depth", "extrinsic_depth"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
        for fa, fb, d in zip(a.frames(), b.frames(), depths):
            assert fa.keys() == fb.keys()
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            np.testing.assert_array_equal(a.decode_depth(fa["depth_bytes"]),
                                          d)
    outs = []
    for mod, sub in ((TS, "torch"), (JS, "jax")):
        out = tmp_path / sub
        assert mod.extract(path, str(out), every_nth=2) == 2
        outs.append(out)
    names = sorted(str(p.relative_to(outs[0])) for p in outs[0].rglob("*"))
    assert names == sorted(str(p.relative_to(outs[1]))
                           for p in outs[1].rglob("*"))
    for n in names:
        if (outs[0] / n).is_file():
            assert (outs[0] / n).read_bytes() == (outs[1] / n).read_bytes(), n


# --- offline trainer, preload, runtime -------------------------------------

def test_train_offline_checkpoint_loads_in_jax(replica_scene,  # noqa: F811
                                               tmp_path, capsys):
    from legslam_torch.apps.train_offline import main
    out = tmp_path / "offline"
    main(["--data", str(replica_scene), "--out", str(out), "--iterations",
          "4", "--frame-stride", "2", "--test-hold", "3", "--eval-every",
          "2", "--capacity", "4096", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "iter 2:" in text and "iter 4:" in text and "saved" in text
    psnr = float(text.split("iter 4:")[1].split("test-PSNR=")[1].split()[0])
    assert np.isfinite(psnr)
    path = str(out / "checkpoint.npz")
    jst, meta = JC.load_checkpoint(path)
    assert meta == dict(iterations=4)
    st, _ = TC.load_checkpoint(path, device="cpu")
    _assert_tree_equal(jax_state_tree(jst), TG.state_to_numpy(st))
    assert int(jst.adam_step) == 4 and int(jst.num_valid()) > 100
    assert np.isfinite(np.asarray(jst.params.xyz)).all()


def test_synthetic_preload(tmp_path):
    from legslam_torch.data.synthetic import SyntheticDataset

    def ds():
        return SyntheticDataset(n_frames=3, width=48, height=32,
                                n_gaussians=300, seed=3, device="cpu")
    a = ds()
    a.preload(str(tmp_path))
    files = list(tmp_path.glob("gt_*.npz"))
    assert len(files) == 1 and a.cache_key() in files[0].name
    b = ds()
    b.preload(str(tmp_path))           # read back from the npz
    c = ds()
    c.preload()                        # in memory only
    for i in range(3):
        for other in (b, c):
            np.testing.assert_array_equal(a.read(i).color,
                                          other.read(i).color)
            np.testing.assert_array_equal(a.read(i).depth,
                                          other.read(i).depth)
        assert np.array_equal(b.read(i).c2w, a.read(i).c2w)
    assert len(list(tmp_path.glob("gt_*.npz"))) == 1
    assert SyntheticDataset(n_frames=3, width=48, height=32, n_gaussians=300,
                            seed=4, device="cpu").cache_key() != a.cache_key()


def test_runtime_helpers(tmp_path):
    from legslam_torch.utils import runtime
    sink = []
    with runtime.timed("x", sink):
        torch.ones(4).sum()
    assert sink[0][0] == "x" and sink[0][1] >= 0.0
    with runtime.profile_trace(str(tmp_path / "prof")) as d:
        torch.ones(8) @ torch.ones(8)
    trace = os.path.join(d, "trace.json")
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert runtime.device_memory_stats() == {} or torch.cuda.is_available()
    runtime.save_peak_memory(str(tmp_path / "peak.txt"),
                             torch.device("cpu"))
    assert (tmp_path / "peak.txt").read_text() == \
        "cpu peak_mb=not measured\n"
