"""The per-gaussian render prologue as one kernel launch each way.

Replaces no TPU kernel: the JAX package's prologue (projection, EWA conic
and radius, SH colour, the fused feature matrix) is jnp code that XLA fuses
into a few loops, while the port, run eagerly, paid one launch per
elementwise operation: ~290 forward and ~650 autograd launches a mapping
iteration, three passes of it an iteration counting the binning cache's
fill, whose host time paced the step (PERF.md section 5). The kernel pair
is CUDA C++ for sm_90a (legslam_torch/csrc/prologue.cu): the forward
writes mean2d (plus the optional offset), conic, depth, radius, mask and
the feature matrix [colour, LF, depth] of the whole-slab row prefix, and
the inert rows of a skipped slab after it, in one launch; the backward
recomputes the forward from the saved inputs and writes every input's
gradient in one launch. Bound: bytes, ~0.8 KB a row forward at SH degree 3
with 64 LF channels (~30 us for a 2^17-row prefix at 3.35 TB/s).

`prologue` is the entry point of ops/rasterize.py: for CPU tensors it
runs the plain versions (the forward calls preprocess, sh_to_color and
normalize_quat as they are; the backward is the kernel's own formulas in
torch, not autograd), for CUDA tensors the kernels, and raises for other
devices. `prologue_forward.launches` and `prologue_backward.launches`
count the kernels' launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from legslam_torch.config import (COV2D_LOWPASS, NEAR_CLIP, PROJ_W_EPS,
                                  SH_C1, SH_C2, SH_C3, VIEW_CLAMP)
from legslam_torch.ops.projection import Preprocessed, preprocess
from legslam_torch.utils.sh import _sh_basis, sh_to_color
from legslam_torch.utils.transforms import normalize_quat

NORM_EPS = 1e-24   # the guarded rsqrt's floor (utils/transforms, utils/sh)


class View(NamedTuple):
    """What the prologue reads of a camera."""
    world_view: torch.Tensor         # [4, 4]
    full_proj: torch.Tensor          # [4, 4]
    cam_center: torch.Tensor | None  # [3]; only the SH colour reads it
    width: int
    height: int
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float
    scale_modifier: float = 1.0


def inert_rows(n: int, device, n_feat: int | None = None):
    """The rows past the whole-slab prefix (cfg.p_slabs): mask False and
    radius 0 keep them out of binning and the statistics; mean2d -1e6 with
    a unit conic gives any consumer alpha 0, as culled rows get."""
    pre = Preprocessed(
        mean2d=torch.full((n, 2), -1e6, device=device),
        conic=torch.tensor([[1.0, 0.0, 1.0]], device=device).repeat(n, 1),
        depth=torch.zeros(n, device=device),
        radius=torch.zeros(n, dtype=torch.int32, device=device),
        mask=torch.zeros(n, dtype=torch.bool, device=device))
    if n_feat is None:
        return pre
    return pre, torch.zeros(n, n_feat, device=device)


def _n_feat(colors_or_sh, lang_feat) -> int | None:
    if colors_or_sh is None:
        return None
    return 3 + (0 if lang_feat is None else lang_feat.shape[1]) + 1


def prologue_forward_plain(xyz, scales, quats, valid, view: View, rows: int,
                           sh=None, colors=None, lang_feat=None, offset=None,
                           active_sh_degree: int = 0):
    """Plain PyTorch version of the forward kernel, same arguments and
    outputs: the prologue of render_arrays on rows [0, rows) and the inert
    rows after them."""
    P = xyz.shape[0]
    m = rows
    pre = preprocess(xyz[:m], scales[:m], normalize_quat(quats[:m]),
                     valid[:m], view.world_view, view.full_proj, view.width,
                     view.height, view.focal_x, view.focal_y, view.tan_fovx,
                     view.tan_fovy, view.scale_modifier)
    if offset is not None:
        pre = pre._replace(mean2d=pre.mean2d + offset[:m])
    feats = None
    n_feat = _n_feat(sh if colors is None else colors, lang_feat)
    if n_feat is not None:
        rgb = colors[:m] if colors is not None else \
            sh_to_color(active_sh_degree, sh[:m], xyz[:m], view.cam_center)
        lf = [] if lang_feat is None else [lang_feat[:m]]
        feats = torch.cat([rgb, *lf, pre.depth[:, None]], dim=-1)
    if m == P:
        return pre, feats
    tail = inert_rows(P - m, xyz.device, n_feat)
    if n_feat is None:
        return Preprocessed(*(torch.cat(p) for p in zip(pre, tail))), None
    pre = Preprocessed(*(torch.cat(p) for p in zip(pre, tail[0])))
    return pre, torch.cat([feats, tail[1]])


def _normalized(v):
    """v * rsqrt(max(|v|^2, eps)) over the last axis, with the rsqrt and
    the squared norm."""
    n2 = torch.sum(v * v, dim=-1)
    r = torch.rsqrt(torch.clamp_min(n2, NORM_EPS))
    return v * r[:, None], r, n2


def _normalized_bwd(v, r, n2, g):
    """dL/dv of _normalized: g r - r^3 (g . v) v where the clamp passed."""
    s = torch.where(n2 >= NORM_EPS, r ** 3 * torch.sum(g * v, dim=-1), 0.0)
    return g * r[:, None] - s[:, None] * v


def _rotation(q):
    """[m, 3, 3] rotation of unit wxyz quaternions (forward.cu:131-136)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def _rotation_bwd(q, dR):
    """dL/dq of _rotation from dL/dR [m, 3, 3]."""
    w, x, y, z = q.unbind(-1)
    d = dR.reshape(-1, 9).unbind(-1)
    return 2 * torch.stack([
        -z * d[1] + y * d[2] + z * d[3] - x * d[5] - y * d[6] + x * d[7],
        y * d[1] + z * d[2] + y * d[3] - 2 * x * d[4] - w * d[5]
        + z * d[6] + w * d[7] - 2 * x * d[8],
        -2 * y * d[0] + x * d[1] + w * d[2] + x * d[3] + z * d[5]
        - w * d[6] + z * d[7] - 2 * y * d[8],
        -2 * z * d[0] - w * d[1] + x * d[2] + w * d[3] - 2 * z * d[4]
        + y * d[5] + x * d[6] + y * d[7]], -1)


def _sh_basis_bwd(deg: int, dirs, db):
    """dL/ddirs [m, 3] of utils/sh._sh_basis from dL/dbasis [m, nb]."""
    x, y, z = dirs.unbind(-1)
    b = db.unbind(-1)
    gx = -SH_C1 * b[3]
    gy = -SH_C1 * b[1]
    gz = SH_C1 * b[2]
    if deg > 1:
        c2 = SH_C2
        gx = gx + c2[0] * y * b[4] - 2 * c2[2] * x * b[6] + c2[3] * z * b[7] \
            + 2 * c2[4] * x * b[8]
        gy = gy + c2[0] * x * b[4] + c2[1] * z * b[5] - 2 * c2[2] * y * b[6] \
            - 2 * c2[4] * y * b[8]
        gz = gz + c2[1] * y * b[5] + 4 * c2[2] * z * b[6] + c2[3] * x * b[7]
    if deg > 2:
        c3 = SH_C3
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + c3[0] * 6 * x * y * b[9] + c3[1] * y * z * b[10] \
            - c3[2] * 2 * x * y * b[11] - c3[3] * 6 * x * z * b[12] \
            + c3[4] * (4 * zz - 3 * xx - yy) * b[13] \
            + c3[5] * 2 * x * z * b[14] + c3[6] * 3 * (xx - yy) * b[15]
        gy = gy + c3[0] * 3 * (xx - yy) * b[9] + c3[1] * x * z * b[10] \
            + c3[2] * (4 * zz - xx - 3 * yy) * b[11] \
            - c3[3] * 6 * y * z * b[12] - c3[4] * 2 * x * y * b[13] \
            - c3[5] * 2 * y * z * b[14] - c3[6] * 6 * x * y * b[15]
        gz = gz + c3[1] * x * y * b[10] + c3[2] * 8 * y * z * b[11] \
            + c3[3] * (6 * zz - 3 * xx - 3 * yy) * b[12] \
            + c3[4] * 8 * x * z * b[13] + c3[5] * (xx - yy) * b[14]
    return torch.stack([gx, gy, gz], -1)


def prologue_backward_plain(xyz, scales, quats, sh, view: View, rows: int,
                            g_mean2d, g_conic, g_feats,
                            active_sh_degree: int = 0,
                            stop_depth_grad: bool = True,
                            with_offset: bool = False):
    """Plain PyTorch version of the backward kernel: the forward recomputed
    from the inputs and differentiated by hand, with the plain version's
    autograd masks. g_feats may be None (no feature gradient). Returns
    (dxyz, dscales, dquats, dsh or None, doffset or None), zero past
    `rows`."""
    P, m = xyz.shape[0], rows
    dev = xyz.device
    wv, fp = view.world_view, view.full_proj
    p = xyz[:m]
    x, y, z = p.unbind(-1)
    t = torch.stack([wv[r, 0] * x + wv[r, 1] * y + wv[r, 2] * z + wv[r, 3]
                     for r in range(3)], -1)
    tz = t[:, 2]
    front = tz > NEAR_CLIP
    gm = g_mean2d[:m]

    # the projected mean
    h = torch.stack([fp[r, 0] * x + fp[r, 1] * y + fp[r, 2] * z + fp[r, 3]
                     for r in (0, 1, 3)], -1)
    pw = 1.0 / (h[:, 2] + PROJ_W_EPS)
    dnx = gm[:, 0] * 0.5 * view.width
    dny = gm[:, 1] * 0.5 * view.height
    dpw = dnx * h[:, 0] + dny * h[:, 1]
    dh = torch.stack([dnx * pw, dny * pw, -dpw * pw * pw], -1)
    dp = torch.where(front[:, None], dh, 0.0) @ fp[[0, 1, 3], :3]

    # the conic, through the EWA cov2D, Sigma and the quaternion
    q1, r1, n1 = _normalized(quats[:m])
    q2, r2, n2 = _normalized(q1)
    R = _rotation(q2)
    sv = scales[:m] * view.scale_modifier
    M = R * sv[:, None, :]
    sigma = M @ M.transpose(1, 2)
    tzc = torch.where(front, tz, 1.0)
    lim = torch.tensor([VIEW_CLAMP * view.tan_fovx,
                        VIEW_CLAMP * view.tan_fovy], device=dev)
    u = t[:, :2] / tzc[:, None]
    tc = torch.minimum(torch.maximum(u, -lim), lim) * tzc[:, None]
    inv_z = 1.0 / tzc
    inv_z2 = inv_z * inv_z
    fx, fy = view.focal_x, view.focal_y
    j00, j11 = fx * inv_z, fy * inv_z
    j02 = -fx * tc[:, 0] * inv_z2
    j12 = -fy * tc[:, 1] * inv_z2
    t0 = j00[:, None] * wv[0, :3] + j02[:, None] * wv[2, :3]
    t1 = j11[:, None] * wv[1, :3] + j12[:, None] * wv[2, :3]
    va = (sigma @ t0[:, :, None])[..., 0]
    vb = (sigma @ t1[:, :, None])[..., 0]
    c00 = torch.where(front, (t0 * va).sum(-1) + COV2D_LOWPASS, 1.0)
    c01 = torch.where(front, (t1 * va).sum(-1), 1.0)
    c11 = torch.where(front, (t1 * vb).sum(-1) + COV2D_LOWPASS, 1.0)
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    di = 1.0 / torch.where(det_ok, det, 1.0)
    ga, gb, gc = torch.where(front[:, None], g_conic[:m], 0.0).unbind(-1)
    dc00, dc11, dc01 = gc * di, ga * di, -gb * di
    ddet = torch.where(det_ok, -(ga * c11 - gb * c01 + gc * c00) * di * di,
                       0.0)
    dc00 = dc00 + ddet * c11
    dc11 = dc11 + ddet * c00
    dc01 = dc01 - 2 * ddet * c01
    dt0 = 2 * dc00[:, None] * va + dc01[:, None] * vb
    dt1 = dc01[:, None] * va + 2 * dc11[:, None] * vb

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]
    g_sigma = dc00[:, None, None] * outer(t0, t0) + \
        dc01[:, None, None] * outer(t1, t0) + \
        dc11[:, None, None] * outer(t1, t1)
    dM = (g_sigma + g_sigma.transpose(1, 2)) @ M
    dscales = (dM * R).sum(1) * view.scale_modifier
    dq = _rotation_bwd(q2, dM * sv[:, None, :])
    dq = _normalized_bwd(quats[:m], r1, n1, _normalized_bwd(q1, r2, n2, dq))
    dj00 = (dt0 * wv[0, :3]).sum(-1)
    dj02 = (dt0 * wv[2, :3]).sum(-1)
    dj11 = (dt1 * wv[1, :3]).sum(-1)
    dj12 = (dt1 * wv[2, :3]).sum(-1)
    dinv_z2 = dj02 * (-fx * tc[:, 0]) + dj12 * (-fy * tc[:, 1])
    dinv_z = dj00 * fx + dj11 * fy + 2 * inv_z * dinv_z2
    dtc = torch.stack([dj02 * -fx * inv_z2, dj12 * -fy * inv_z2], -1)
    clamped = torch.minimum(torch.maximum(u, -lim), lim)
    du = torch.where((u >= -lim) & (u <= lim), dtc * tzc[:, None], 0.0)
    dtz = -dinv_z * inv_z * inv_z + (dtc * clamped).sum(-1) \
        - (du * t[:, :2]).sum(-1) / (tzc * tzc)
    dt = torch.cat([du / tzc[:, None], dtz[:, None]], -1)
    dp = dp + dt @ wv[:3, :3]

    if g_feats is not None and not stop_depth_grad:
        dp = dp + g_feats[:m, -1:] * wv[2, :3]
    dsh = None
    if sh is not None:
        dsh = torch.zeros_like(sh)
        d = p - view.cam_center
        dirs, r, nd = _normalized(d)
        basis = _sh_basis(active_sh_degree, dirs[:, 0:1], dirs[:, 1:2],
                          dirs[:, 2:3])
        nb = len(basis)
        b = torch.cat(basis, -1)                                # [m, nb]
        if g_feats is not None:
            pre = sum(b[:, k:k + 1] * sh[:m, k] for k in range(nb)) + 0.5
            dpre = torch.where(pre >= 0.0, g_feats[:m, :3], 0.0)
            dsh[:m, :nb] = b[:, :, None] * dpre[:, None, :]
            if active_sh_degree > 0:
                db = (sh[:m, :nb] * dpre[:, None, :]).sum(-1)
                gdir = _sh_basis_bwd(active_sh_degree, dirs, db)
                dp = dp + _normalized_bwd(d, r, nd, gdir)

    def full(g, n):
        out = torch.zeros(P, n, device=dev)
        out[:m] = g
        return out
    doffset = full(gm, 2) if with_offset else None
    return full(dp, 3), full(dscales, 3), full(dq, 4), dsh, doffset


# each operand's shape after its leading row axis (None: any width); the
# camera's tensors have no row axis
_SHAPES = dict(xyz=(3,), scales=(3,), quats=(4,), valid=(), sh=(None, 3),
               colors=(3,), lang_feat=(None,), offset=(2,), g_mean2d=(2,),
               g_conic=(3,), g_feats=(None,))
_CAMERA = dict(world_view=(4, 4), full_proj=(4, 4), cam_center=(3,))


def _check(dev, P: int, tensors: dict):
    """Raise for an operand the kernels do not take: another device, a
    dtype other than float32 (valid: bool), or another shape."""
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, xyz on {dev}")
        if x.dtype != (torch.bool if name == "valid" else torch.float32):
            raise TypeError(f"{name} must be float32 (valid bool), "
                            f"got {x.dtype}")
        want = _CAMERA[name] if name in _CAMERA else (P, *_SHAPES[name])
        if len(x.shape) != len(want) or any(
                w is not None and n != w for n, w in zip(x.shape, want)):
            raise ValueError(f"{name} is {tuple(x.shape)}, want {want}")


def _contiguous(*xs):
    """The operands, contiguous, held by the caller until the launch is
    enqueued (a temporary freed earlier could be handed to the next one)."""
    return [None if x is None else x.contiguous() for x in xs]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _scalars(view: View):
    """(width, height, fx, fy, lim_x, lim_y, scale_modifier) as the
    plain version rounds them to float32."""
    return (int(view.width), int(view.height), float(view.focal_x),
            float(view.focal_y), VIEW_CLAMP * float(view.tan_fovx),
            VIEW_CLAMP * float(view.tan_fovy), float(view.scale_modifier))


def prologue_forward(xyz, scales, quats, valid, view: View, rows: int,
                     sh=None, colors=None, lang_feat=None, offset=None,
                     active_sh_degree: int = 0):
    """The prologue's forward: (Preprocessed, feats) over P rows, computed
    on rows [0, rows) and inert after them. With neither `sh` [P, K, 3]
    nor `colors` [P, 3] only the geometry is computed and feats is None;
    `lang_feat` [P, LF] adds LF columns; `offset` [P, 2] is added to
    mean2d. Launches the kernel for CUDA tensors (counted in
    `prologue_forward.launches`), the plain version for CPU tensors."""
    dev = xyz.device
    if dev.type == "cpu":
        return prologue_forward_plain(xyz, scales, quats, valid, view, rows,
                                      sh, colors, lang_feat, offset,
                                      active_sh_degree)
    if dev.type != "cuda":
        raise ValueError(f"no prologue kernel for device {dev}")
    P = xyz.shape[0]
    _check(dev, P, dict(xyz=xyz, scales=scales, quats=quats, valid=valid,
                        sh=sh, colors=colors, lang_feat=lang_feat,
                        offset=offset, world_view=view.world_view,
                        full_proj=view.full_proj, cam_center=view.cam_center))
    if not 0 <= rows <= P:
        raise ValueError(f"rows {rows} outside [0, {P}]")
    n_coef = 0
    if colors is None and sh is not None:
        n_coef = sh.shape[1]
        if n_coef < (active_sh_degree + 1) ** 2 or active_sh_degree > 3:
            raise ValueError(f"{n_coef} SH coefficients for degree "
                             f"{active_sh_degree}")
        if view.cam_center is None:
            raise ValueError("the SH colour needs the camera centre")
    n_feat = _n_feat(sh if colors is None else colors, lang_feat)
    lf_dim = 0 if lang_feat is None else lang_feat.shape[1]
    pre = Preprocessed(
        mean2d=torch.empty(P, 2, device=dev),
        conic=torch.empty(P, 3, device=dev),
        depth=torch.empty(P, device=dev),
        radius=torch.empty(P, dtype=torch.int32, device=dev),
        mask=torch.empty(P, dtype=torch.bool, device=dev))
    feats = None if n_feat is None else \
        torch.empty(P, n_feat, device=dev)
    if P == 0:
        return pre, feats
    xyz, scales, quats, valid, sh, colors, lang_feat, offset, wv, fp, cc = \
        _contiguous(xyz, scales, quats, valid, sh, colors, lang_feat, offset,
                    view.world_view, view.full_proj, view.cam_center)
    err = _fwd_fn()(
        _ptr(xyz), _ptr(scales), _ptr(quats), _ptr(valid),
        _ptr(sh if colors is None else None), n_coef, active_sh_degree,
        _ptr(colors), _ptr(lang_feat), lf_dim, _ptr(offset), _ptr(wv),
        _ptr(fp), _ptr(cc if n_feat is not None else None),
        *_scalars(view), rows, P,
        *(x.data_ptr() for x in pre), _ptr(feats), n_feat or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"prologue_fwd launch failed: error {err}")
    prologue_forward.launches += 1
    return pre, feats


prologue_forward.launches = 0


def prologue_backward(xyz, scales, quats, sh, view: View, rows: int,
                      g_mean2d, g_conic, g_feats, active_sh_degree: int = 0,
                      stop_depth_grad: bool = True,
                      with_offset: bool = False):
    """The prologue's backward: (dxyz, dscales, dquats, dsh or None,
    doffset or None) from dL/dmean2d, dL/dconic and dL/dfeats (None: no
    feature gradient; its depth column is the last). `sh` None: the
    colour was precomputed. Launches the kernel for CUDA tensors (counted
    in `prologue_backward.launches`), the plain version for CPU
    tensors."""
    dev = xyz.device
    if dev.type == "cpu":
        return prologue_backward_plain(xyz, scales, quats, sh, view, rows,
                                       g_mean2d, g_conic, g_feats,
                                       active_sh_degree, stop_depth_grad,
                                       with_offset)
    if dev.type != "cuda":
        raise ValueError(f"no prologue kernel for device {dev}")
    P = xyz.shape[0]
    _check(dev, P, dict(xyz=xyz, scales=scales, quats=quats, sh=sh,
                        g_mean2d=g_mean2d, g_conic=g_conic, g_feats=g_feats,
                        world_view=view.world_view, full_proj=view.full_proj,
                        cam_center=view.cam_center))
    if g_feats is not None and g_feats.stride(1) != 1:
        g_feats = g_feats.contiguous()
    dxyz = torch.empty(P, 3, device=dev)
    dscales = torch.empty(P, 3, device=dev)
    dquats = torch.empty(P, 4, device=dev)
    dsh = None if sh is None else torch.empty_like(sh)
    doffset = torch.empty(P, 2, device=dev) if with_offset else None
    if P == 0:
        return dxyz, dscales, dquats, dsh, doffset
    xyz, scales, quats, sh, wv, fp, cc, g_mean2d, g_conic = _contiguous(
        xyz, scales, quats, sh, view.world_view, view.full_proj,
        view.cam_center, g_mean2d, g_conic)
    err = _bwd_fn()(
        _ptr(xyz), _ptr(scales), _ptr(quats), _ptr(sh),
        0 if sh is None else sh.shape[1], active_sh_degree, _ptr(wv),
        _ptr(fp), _ptr(cc if sh is not None else None),
        *_scalars(view), rows, P, _ptr(g_mean2d), _ptr(g_conic),
        None if g_feats is None else g_feats.data_ptr(),
        0 if g_feats is None else g_feats.stride(0),
        0 if g_feats is None else g_feats.shape[1] - 1,
        int(stop_depth_grad), dxyz.data_ptr(), dscales.data_ptr(),
        dquats.data_ptr(), _ptr(dsh), _ptr(doffset),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"prologue_bwd launch failed: error {err}")
    prologue_backward.launches += 1
    return dxyz, dscales, dquats, dsh, doffset


prologue_backward.launches = 0


def _fwd_fn():
    from legslam_torch import _build
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function(
        "prologue", "legslam_prologue_fwd",
        [vp, vp, vp, vp, vp, i, i, vp, vp, i, vp, vp, vp, vp,
         i, i, f, f, f, f, f, i, i, vp, vp, vp, vp, vp, vp, i, vp])


def _bwd_fn():
    from legslam_torch import _build
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function(
        "prologue", "legslam_prologue_bwd",
        [vp, vp, vp, vp, i, i, vp, vp, vp, i, i, f, f, f, f, f, i, i,
         vp, vp, vp, i, i, i, vp, vp, vp, vp, vp, vp])


class Prologue(torch.autograd.Function):
    """The prologue, differentiable in xyz, scales, quats, sh or colors,
    lang_feat and offset through mean2d, conic and feats. Saves the
    inputs and recomputes in the backward; the LF's and a precomputed
    colour's gradients are views of dL/dfeats."""

    @staticmethod
    def forward(ctx, xyz, scales, quats, sh, colors, lang_feat, offset,
                valid, view, rows, active_sh_degree, stop_depth_grad):
        pre, feats = prologue_forward(xyz, scales, quats, valid, view, rows,
                                      sh, colors, lang_feat, offset,
                                      active_sh_degree)
        ctx.save_for_backward(xyz, scales, quats,
                              sh if colors is None else None)
        ctx.view, ctx.rows = view, rows
        ctx.deg, ctx.stop = active_sh_degree, stop_depth_grad
        ctx.lf_dim = 0 if lang_feat is None else lang_feat.shape[1]
        ctx.with_offset = offset is not None
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(pre.depth, pre.radius, pre.mask)
        return (*pre, feats)

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, _g_depth, _g_radius, _g_mask,
                 g_feats):
        xyz, scales, quats, sh = ctx.saved_tensors
        if g_mean2d is None:
            g_mean2d = torch.zeros(xyz.shape[0], 2, device=xyz.device)
        if g_conic is None:
            g_conic = torch.zeros(xyz.shape[0], 3, device=xyz.device)
        dxyz, dscales, dquats, dsh, doffset = prologue_backward(
            xyz, scales, quats, sh, ctx.view, ctx.rows,
            g_mean2d, g_conic, g_feats, ctx.deg,
            ctx.stop, ctx.with_offset)
        want_colors, want_lf, want_offset = ctx.needs_input_grad[4:7]
        views = g_feats is not None
        dcolors = g_feats[:, :3] if want_colors and views else None
        dlf = g_feats[:, 3:3 + ctx.lf_dim] if want_lf and views else None
        return (dxyz, dscales, dquats, dsh, dcolors, dlf,
                doffset if want_offset else None,
                None, None, None, None, None)


def prologue(xyz, scales, quats, valid, view: View, rows: int | None = None,
             *, sh=None, colors=None, lang_feat=None, offset=None,
             active_sh_degree: int = 0, stop_depth_grad: bool = True):
    """The render prologue of ops/rasterize.py: (Preprocessed, feats [P,
    3 (+LF) + 1]) on the whole-slab prefix `rows` (default all P rows),
    differentiable through mean2d, conic and feats; stop_depth_grad keeps
    the depth column's gradient off the means, as the reference does
    (backward.cu:573-580). With neither `sh` nor `colors`, only the
    geometry, without gradient, and feats None (binning)."""
    rows = xyz.shape[0] if rows is None else rows
    if sh is None and colors is None:
        return prologue_forward(xyz, scales, quats, valid, view, rows,
                                offset=offset)
    out = Prologue.apply(xyz, scales, quats, sh, colors, lang_feat, offset,
                         valid, view, rows, active_sh_degree,
                         stop_depth_grad)
    return Preprocessed(*out[:5]), out[5]
