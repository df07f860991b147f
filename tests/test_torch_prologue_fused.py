"""The fused render prologue (legslam_torch/ops/cuda/prologue.py) on the
CPU, where its wrapper runs the plain twin: the forward through preprocess,
sh_to_color and normalize_quat, the backward by the kernel's own explicit
formulas. Both are held against legslam_tpu's prologue (the body of its
render_arrays: preprocess, SH, the fused feature matrix, the slab prefix)
and its JAX gradients, and the backward against autograd through the
port's own prologue ops.

Tolerances (tests/test_torch_prologue.py's): values atol 1e-5 / rtol 1e-5,
pixel positions atol 1e-4, radius and mask bit-exact; gradients atol 1e-6
x the largest reference gradient of the input / rtol 1e-4.

The scene has padded rows (valid False, every parameter zero, as the store
keeps them), valid rows behind the near plane (z <= 0.2) and a valid row
in front with a zero quaternion. JAX's quaternion gradient is NaN at a
zero quaternion, so those rows are held to autograd only. The row's conic
cotangent is zero: a zero
quaternion's direction derivative is scaled by rsqrt(1e-24) = 1e12 on
both sides, which would swamp the tolerance scale; the store's zero
quaternions are its padded rows, which no pair reaches. Past a slab
prefix every cotangent is zero, as every consumer gives them (mask False,
radius 0: no pair), since the LF's gradient is a view of dL/dfeats.

The card's half (the kernels against this plain twin, the mapping step
and binning through them) is tests/test_torch_prologue_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.ops import projection as JP
from legslam_tpu.ops.rasterize import _pre_skip_out as jax_skip_out
from legslam_tpu.ops.slabs import prefix_map as jax_prefix_map
from legslam_tpu.utils import camera as JC
from legslam_tpu.utils import sh as JS
from legslam_tpu.utils import transforms as JT
from legslam_torch.ops.cuda import prologue as PR
from legslam_torch.ops.projection import preprocess
from legslam_torch.utils.sh import sh_to_color
from legslam_torch.utils.transforms import normalize_quat

from .torch_parity import assert_close, np_, t_, torch_view

torch.set_num_threads(1)

N_LIVE, CAP, LF = 300, 512, 8
W, H = 160, 96


def _scene(seed: int):
    """Live rows 0..N_LIVE-1 (the first 6 behind the near plane, row 6 a
    zero quaternion in front), padded zero rows after them."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(CAP, 3)) * [1.2, 0.8, 1.0] + [0, 0, 4]).astype(
        np.float32)
    xyz[:6] = rng.uniform([-0.3, -0.3, -1.5], [0.3, 0.3, -0.6], size=(6, 3))
    scales = np.exp(rng.uniform(-3.5, -1.5, size=(CAP, 3))).astype(
        np.float32)
    quats = rng.normal(size=(CAP, 4)).astype(np.float32)
    quats[6] = 0.0
    sh = (rng.normal(size=(CAP, 16, 3)) * 0.3).astype(np.float32)
    sh[:, 0] += 0.4
    colors = rng.uniform(-0.2, 1.0, size=(CAP, 3)).astype(np.float32)
    lf = rng.normal(size=(CAP, LF)).astype(np.float32)
    offset = np.zeros((CAP, 2), np.float32)
    valid = np.zeros(CAP, bool)
    valid[:N_LIVE] = True
    for a in (xyz, scales, quats, sh, colors, lf):
        a[N_LIVE:] = 0.0
    return dict(xyz=xyz, scales=scales, quats=quats, sh=sh, colors=colors,
                lang_feat=lf, offset=offset, valid=valid)


def _view():
    """A camera turned ~10 degrees about two axes and moved off the
    origin, so every entry of world_view and full_proj enters."""
    a, b = np.deg2rad(9.0), np.deg2rad(-7.0)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    R = (rx @ ry).astype(np.float32)
    t = np.asarray([0.15, -0.1, 0.2], np.float32)
    return JC.CameraView.create(R, t, W, H, fx=120.0, fy=110.0)


# (name, SH degree or None for colors_precomp, LF, stop_depth_grad,
#  scale_modifier, slabs)
CASES = [
    ("deg0", 0, True, True, 1.0, 0),
    ("deg1_depth_grad", 1, True, False, 1.0, 0),
    ("deg2_no_lf", 2, False, True, 1.0, 0),
    ("deg3", 3, True, True, 1.0, 0),
    ("deg3_modifier_depth_grad", 3, True, False, 0.7, 0),
    ("colors_precomp", None, True, False, 1.0, 0),
    ("colors_precomp_no_lf", None, False, True, 1.3, 0),
    ("deg3_slab_prefix", 3, True, True, 1.0, 4),
    ("deg1_slab_prefix_no_lf", 1, False, False, 0.9, 4),
]
IDS = [c[0] for c in CASES]


def _prefix(n_slabs):
    if not n_slabs:
        return CAP
    slab = CAP // n_slabs
    return slab * -(-N_LIVE // slab)


def _cotangents(seed, n_feat, rows):
    rng = np.random.default_rng(seed + 100)
    g = dict(mean2d=rng.normal(size=(CAP, 2)) * 0.1,
             conic=rng.normal(size=(CAP, 3)) * 0.01,
             feats=rng.normal(size=(CAP, n_feat)))
    g["conic"][6] = 0.0
    for v in g.values():
        v[rows:] = 0.0
    return {k: v.astype(np.float32) for k, v in g.items()}


def _inputs(deg, lf):
    """The differentiable inputs of a case, by the prologue's names."""
    names = ["xyz", "scales", "quats", "sh" if deg is not None else "colors"]
    return names + (["lang_feat"] if lf else []) + ["offset"]


def _jax_prologue(scene, jview, deg, lf, stop, smod, n_slabs):
    """legslam_tpu's render_arrays prologue as a function of the case's
    inputs: (mean2d, conic, feats) and (depth, radius, mask)."""
    focal_x = W / (2.0 * jview.tan_fovx)
    focal_y = H / (2.0 * jview.tan_fovy)
    valid = jnp.asarray(scene["valid"])
    n_feat = 3 + (LF if lf else 0) + 1

    def pre_feats(a):
        pre = JP.preprocess(a["xyz"], a["scales"], JT.normalize_quat(
            a["quats"]), a["valid"], jview.world_view, jview.full_proj, W, H,
            focal_x, focal_y, jview.tan_fovx, jview.tan_fovy, smod)
        pre = pre._replace(mean2d=pre.mean2d + a["offset"])
        rgb = a["colors"] if deg is None else JS.sh_to_color(
            deg, a["sh"], a["xyz"], jview.cam_center)
        depth = jax.lax.stop_gradient(pre.depth) if stop else pre.depth
        parts = [rgb] + ([a["lang_feat"]] if lf else []) + [depth[:, None]]
        return pre, jnp.concatenate(parts, axis=-1)

    def fn(*xs):
        args = dict(zip(_inputs(deg, lf), xs), valid=valid)
        if n_slabs:
            hi = jnp.max(jnp.where(valid, jnp.arange(1, CAP + 1), 0))
            pre, feats = jax_prefix_map(
                pre_feats, lambda a: jax_skip_out(a["valid"].shape[0],
                                                  n_feat),
                args, hi, n_slabs)
        else:
            pre, feats = pre_feats(args)
        return (pre.mean2d, pre.conic, feats), (pre.depth, pre.radius,
                                                pre.mask)
    return fn


def _torch_leaves(scene, deg, lf):
    return {k: t_(scene[k]).requires_grad_(True) for k in _inputs(deg, lf)}


def _run_fused(scene, view, deg, lf, stop, smod, rows):
    leaves = _torch_leaves(scene, deg, lf)
    pview = PR.View(view.world_view, view.full_proj, view.cam_center, W, H,
                    view.focal_x, view.focal_y, view.tan_fovx,
                    view.tan_fovy, smod)
    pre, feats = PR.prologue(
        leaves["xyz"], leaves["scales"], leaves["quats"],
        t_(scene["valid"]), pview, rows, sh=leaves.get("sh"),
        colors=leaves.get("colors"), lang_feat=leaves.get("lang_feat"),
        offset=leaves["offset"], active_sh_degree=deg or 0,
        stop_depth_grad=stop)
    return leaves, pre, feats


def _grads(outs, leaves, g):
    return dict(zip(leaves, torch.autograd.grad(
        outs, list(leaves.values()),
        grad_outputs=[t_(g["mean2d"]), t_(g["conic"]), t_(g["feats"])],
        allow_unused=True)))


def _grad_close(g, ref, name):
    ref = np_(ref)
    g = np.zeros_like(ref) if g is None else np_(g)
    assert_close(g, ref, 1e-6 * max(np.abs(ref).max(), 1e-30), 1e-4, name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_twin_matches_jax(case):
    """The plain twin's forward and explicit backward against the JAX
    prologue's values and vjp."""
    name, deg, lf, stop, smod, n_slabs = case
    seed = IDS.index(name)
    scene = _scene(seed)
    jview = _view()
    view = torch_view(jview)
    rows = _prefix(n_slabs)
    assert rows < CAP or not n_slabs    # the slab cases have a tail
    n_feat = 3 + (LF if lf else 0) + 1
    g = _cotangents(seed, n_feat, rows)

    fn = _jax_prologue(scene, jview, deg, lf, stop, smod, n_slabs)
    jx = [jnp.asarray(scene[k]) for k in _inputs(deg, lf)]
    (jout, vjp, jaux) = jax.vjp(fn, *jx, has_aux=True)
    jgrads = vjp((jnp.asarray(g["mean2d"]), jnp.asarray(g["conic"]),
                  jnp.asarray(g["feats"])))

    leaves, pre, feats = _run_fused(scene, view, deg, lf, stop, smod, rows)
    assert_close(pre.mean2d.detach(), jout[0], 1e-4, 1e-5, "mean2d")
    assert_close(pre.conic.detach(), jout[1], 1e-5, 1e-5, "conic")
    assert_close(feats.detach(), jout[2], 1e-5, 1e-5, "feats")
    assert_close(pre.depth, jaux[0], 1e-5, 1e-5, "depth")
    np.testing.assert_array_equal(np_(pre.radius), np.asarray(jaux[1]))
    np.testing.assert_array_equal(np_(pre.mask), np.asarray(jaux[2]))
    m = np_(pre.mask)
    assert not m[:6].any() and not m[N_LIVE:].any() and m.sum() > 200
    if n_slabs:     # the tail is legslam_tpu's _pre_skip_out, bit for bit
        tail, tail_feats = jax_skip_out(CAP - rows, n_feat)
        for t, j in zip((*pre, feats), (*tail, tail_feats)):
            np.testing.assert_array_equal(np_(t)[rows:], np.asarray(j))

    grads = _grads((pre.mean2d, pre.conic, feats), leaves, g)
    zero_q = ~scene["quats"].any(-1)
    for (k, gt), jg in zip(grads.items(), jgrads):
        jg = np.asarray(jg)
        assert np.isfinite(np_(gt)).all(), f"d {k} not finite"
        if k == "quats":    # JAX's is NaN at zero quaternions; the
            # port's stays finite there (test_padded_rows_have_finite_grads)
            rows_nan = ~np.isfinite(jg).all(-1)
            assert not rows_nan[~zero_q].any()
            gt, jg = gt[~torch.as_tensor(rows_nan)], jg[~rows_nan]
        _grad_close(gt, jg, "d " + k)
        if n_slabs:
            assert not np_(gt)[rows:].any(), f"d {k} past the prefix"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_explicit_backward_matches_autograd(case):
    """The explicit backward against autograd through the port's own
    prologue ops (the render path as it was before the fused pair)."""
    name, deg, lf, stop, smod, n_slabs = case
    seed = IDS.index(name)
    scene = _scene(seed)
    view = torch_view(_view())
    rows = _prefix(n_slabs)
    n_feat = 3 + (LF if lf else 0) + 1
    g = _cotangents(seed, n_feat, rows)

    ref = _torch_leaves(scene, deg, lf)
    sl = {k: v[:rows] for k, v in ref.items()}
    pre = preprocess(sl["xyz"], sl["scales"], normalize_quat(sl["quats"]),
                     t_(scene["valid"])[:rows], view.world_view,
                     view.full_proj, W, H, view.focal_x, view.focal_y,
                     view.tan_fovx, view.tan_fovy, smod)
    rgb = sl["colors"] if deg is None else sh_to_color(
        deg, sl["sh"], sl["xyz"], view.cam_center)
    depth = pre.depth.detach() if stop else pre.depth
    feats = torch.cat([rgb] + ([sl["lang_feat"]] if lf else [])
                      + [depth[:, None]], -1)
    gr = {k: t_(v[:rows]) for k, v in g.items()}
    want = dict(zip(ref, torch.autograd.grad(
        (pre.mean2d + sl["offset"], pre.conic, feats), list(ref.values()),
        grad_outputs=[gr["mean2d"], gr["conic"], gr["feats"]],
        allow_unused=True)))

    leaves, pre_f, feats_f = _run_fused(scene, view, deg, lf, stop, smod,
                                        rows)
    got = _grads((pre_f.mean2d, pre_f.conic, feats_f), leaves, g)
    for k in ref:
        w = torch.zeros_like(ref[k]) if want[k] is None else want[k]
        _grad_close(got[k], w, "d " + k)


def test_geometry_only_and_no_launch_on_cpu():
    """Without colour inputs only the geometry is computed (binning's
    call), equal to the full call's; CPU tensors launch no kernel; other
    devices raise."""
    scene = _scene(11)
    view = torch_view(_view())
    pview = PR.View(view.world_view, view.full_proj, None, W, H,
                    view.focal_x, view.focal_y, view.tan_fovx,
                    view.tan_fovy)
    launches = (PR.prologue_forward.launches, PR.prologue_backward.launches)
    args = [t_(scene[k]) for k in ("xyz", "scales", "quats", "valid")]
    pre, feats = PR.prologue(*args, pview, 256)
    assert feats is None
    full, _ = PR.prologue(*args, pview._replace(cam_center=view.cam_center),
                          256, sh=t_(scene["sh"]), active_sh_degree=3)
    for a, b in zip(pre, full):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert (PR.prologue_forward.launches,
            PR.prologue_backward.launches) == launches
    with pytest.raises(ValueError, match="no prologue kernel"):
        PR.prologue(*(a.to("meta") for a in args), pview, 256)


@pytest.mark.parametrize("name, bad", [
    ("sh", torch.zeros(8, 16, 4)), ("quats", torch.zeros(8, 3)),
    ("valid", torch.zeros(8)), ("cam_center", torch.zeros(4)),
    ("lang_feat", torch.zeros(9, 64)), ("xyz", torch.zeros(8, 3).double()),
])
def test_kernel_operands_are_checked(name, bad):
    """What the kernels are handed is checked first: a wrong shape, dtype
    or row count raises before any pointer is passed."""
    ops = dict(xyz=torch.zeros(8, 3), scales=torch.zeros(8, 3),
               quats=torch.zeros(8, 4), valid=torch.zeros(8, dtype=bool),
               sh=torch.zeros(8, 16, 3), lang_feat=torch.zeros(8, 64),
               offset=torch.zeros(8, 2), world_view=torch.zeros(4, 4),
               full_proj=torch.zeros(4, 4), cam_center=torch.zeros(3))
    PR._check(torch.device("cpu"), 8, ops)
    with pytest.raises((ValueError, TypeError), match=name):
        PR._check(torch.device("cpu"), 8, {**ops, name: bad})
