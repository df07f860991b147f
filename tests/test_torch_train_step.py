"""legslam_torch mapping step vs legslam_tpu's, and the step's own checks.

The parity test converts one JAX state with state_from_numpy and runs 3
steps on both sides through the kernel path (JAX: the Pallas kernels in
interpret mode; port: the "cuda" backend, whose kernel wrappers run their
plain versions on CPU tensors), as one refresh group of the mapper's
binning cache: a fresh binning whose step emits kfin, then two reuse
steps on that binning trimmed at the kfin. Tolerances: each step's loss
rtol 1e-4; every step's kfin and the binnings bit-exact; the first step's gradients (read back from Adam's first
moment, m = 0.1 g) atol 2e-4 x the group's largest gradient / rtol 2e-2
(the JAX suite's gradient tolerance, scaled to the group); the final
parameters atol 1e-5 / rtol 1e-4, except elements whose JAX gradient was
below 1e-8 in magnitude at any step: Adam's early updates are close to
lr * sign(g), so for a gradient that small, rounding noise can flip the
sign of a whole learning-rate step.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import OptimizationParams as JaxOpt
from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.mapper.train_step import train_step as jax_train_step
from legslam_tpu.models import gaussians as JG
from legslam_tpu.ops.binning import trim_binning as jax_trim
from legslam_tpu.ops.rasterize import compute_binning as jax_compute_binning
from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import train_step, upsample_lf
from legslam_torch.models import gaussians as G
from legslam_torch.ops.binning import trim_binning
from legslam_torch.ops.rasterize import compute_binning

from .torch_parity import jax_state_tree, np_, t_, torch_view
from .util import simple_view

torch.set_num_threads(1)

W, H = 128, 64
OPT_KW = dict(position_lr_init=0.0016, position_lr_final=1.6e-5)
SPAN = dict(tile_h=16, tile_w=128, max_span_x=3, max_span_y=8, chunk=64,
            tile_batch=4, max_pairs=2048)


def _scene(n=256, cap=512, seed=0, n_blanket=14):
    """A knn-initialised cloud with anisotropic scales, random rotations
    and opacities in [0.5, 0.95], with `n_blanket` wide opaque gaussians
    in front of the top tile row (the device of the JAX suite's
    tests/test_binning_trim.py, narrowed to one tile): they drive every
    pixel of that tile past T < 1e-4, so kfin trims its tail, while the
    lower tiles see the cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    pts[:, 2] = np.abs(pts[:, 2]) + 2.5
    z = np.linspace(0.9, 1.1, n_blanket)
    # pixel row 7.5 of the fy = 100 view: y / z = (7.5 - 31.5) / 100
    pts[:n_blanket] = np.stack([np.zeros_like(z), -0.24 * z, z], 1)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    lf = rng.normal(size=(n, 64)).astype(np.float32)
    st = JG.create_from_pcd(pts, cols, capacity=cap, lang_feat=lf)
    p = st.params
    sc = np.array(p.scaling) + rng.uniform(-0.4, 0.4, size=(cap, 3))
    sc[:n_blanket] = np.log([1.0, 0.12, 0.05])
    q = rng.normal(size=(cap, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:n_blanket] = [1.0, 0.0, 0.0, 0.0]
    op = rng.uniform(0.5, 0.95, size=cap)
    op[:n_blanket] = 0.97
    st = st.replace(params=p.replace(
        scaling=jnp.asarray(sc, jnp.float32),
        rotation=jnp.asarray(q, jnp.float32),
        opacity=jnp.asarray(np.log(op / (1 - op))[:, None], jnp.float32)))
    gt = dict(gt_color=rng.uniform(size=(H, W, 3)),
              gt_lang_feat=rng.normal(size=(H, W, 64)),
              gt_depth=np.full((H, W), 2.5), mask=np.ones((H, W)),
              bg=np.asarray([0.1, 0.2, 0.3]))
    return st, {k: np.asarray(v, np.float32) for k, v in gt.items()}


def _gt_args(gt, conv):
    return [conv(gt[k]) for k in ("gt_color", "gt_lang_feat", "gt_depth",
                                  "mask", "bg")]


@pytest.fixture(scope="module")
def runs():
    """3 steps on each side from the same state; per step (state, loss,
    kfin, binning)."""
    jst, gt = _scene()
    jview = simple_view(width=W, height=H, fx=100.0, fy=100.0)
    view = torch_view(jview)
    jcfg = JaxCfg(**SPAN, backend="pallas", pallas_interpret=True)
    tcfg = RasterizeConfig(**SPAN, backend="cuda")
    jopt, opt = JaxOpt(**OPT_KW), OptimizationParams(**OPT_KW)
    tst = G.state_from_numpy(jax_state_tree(jst), device="cpu")

    jstep = jax.jit(lambda s, b, i: jax_train_step(
        s, jview.world_view, jview.full_proj, jview.cam_center,
        jview.tan_fovx, jview.tan_fovy, *_gt_args(gt, jnp.asarray), i, 1.0,
        width=W, height=H, active_sh_degree=3, opt=jopt, cfg=jcfg,
        max_per_tile=512, binning=b, emit_kfin=True))

    def jbin(s):
        return jax_compute_binning(
            s.params.xyz, jnp.exp(s.params.scaling), s.params.rotation,
            s.valid, jview.world_view, jview.full_proj, jview.tan_fovx,
            jview.tan_fovy, W, H, jcfg, 512,
            opacity=jax.nn.sigmoid(s.params.opacity[:, 0]))

    def tbin(s):
        return compute_binning(
            s.params.xyz, torch.exp(s.params.scaling), s.params.rotation,
            s.valid, view.world_view, view.full_proj, view.tan_fovx,
            view.tan_fovy, W, H, tcfg, 512,
            opacity=torch.sigmoid(s.params.opacity[:, 0]))

    out = {"jax": [], "torch": []}
    jb, tb = jbin(jst), tbin(tst)
    for i in range(3):
        if i == 1:    # the reuse steps' binning: trimmed at the first kfin
            jb = (jax_trim(jb[0], jkfin, 2048, 64), jb[1])
            tb = (trim_binning(tb[0], tkfin, 2048, 64), tb[1])
        jst, jaux = jstep(jst, jb, jnp.asarray(float(i)))
        tst, taux = train_step(
            tst, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, *_gt_args(gt, t_), float(i), 1.0,
            width=W, height=H, active_sh_degree=3, opt=opt, cfg=tcfg,
            max_per_tile=512, binning=tb, emit_kfin=True)
        jkfin, tkfin = jaux.kfin, taux.kfin
        out["jax"].append((jax_state_tree(jst), float(jaux.loss),
                           np.asarray(jkfin), jb[0]))
        out["torch"].append((G.state_to_numpy(tst), float(taux.loss),
                             np_(tkfin), tb[0]))
    return out


def test_losses_kfin_and_trim_match(runs):
    for i, (j, t) in enumerate(zip(runs["jax"], runs["torch"])):
        assert math.isfinite(t[1])
        np.testing.assert_allclose(t[1], j[1], rtol=1e-4, err_msg=f"loss {i}")
        np.testing.assert_array_equal(t[2], j[2], err_msg=f"kfin {i}")
        for f in j[3]._fields:
            np.testing.assert_array_equal(np_(getattr(t[3], f)),
                                          np.asarray(getattr(j[3], f)),
                                          err_msg=f"binning {i} {f}")
    # the trim dropped pairs the reuse step no longer composites
    assert int(runs["torch"][1][3].num_rendered) < \
        int(runs["torch"][0][3].num_rendered)


def _grads(tree_prev, tree):
    """Per-step gradients from Adam's first moment: g = (m - 0.9 m') / 0.1."""
    return {n: (tree["adam_m"][n] - 0.9 * tree_prev["adam_m"][n]) / 0.1
            for n in G.GROUPS}


def test_first_step_gradients_match(runs):
    zero = {"adam_m": {n: 0.0 for n in G.GROUPS}}
    gj = _grads(zero, runs["jax"][0][0])
    gt = _grads(zero, runs["torch"][0][0])
    for n in G.GROUPS:
        scale = np.abs(gj[n]).max()
        assert scale > 0, n
        np.testing.assert_allclose(gt[n], gj[n], atol=2e-4 * scale,
                                   rtol=2e-2, err_msg=n)


def test_final_state_matches(runs):
    tj, tt = runs["jax"][-1][0], runs["torch"][-1][0]
    small = {n: np.zeros(tj["params"][n].shape, bool) for n in G.GROUPS}
    prev = {"adam_m": {n: 0.0 for n in G.GROUPS}}
    for j in runs["jax"]:
        for n, g in _grads(prev, j[0]).items():
            small[n] |= np.abs(g) < 1e-8
        prev = j[0]
    for n in G.GROUPS:
        keep = ~small[n]
        assert keep.sum() > 100, n
        np.testing.assert_allclose(tt["params"][n][keep],
                                   tj["params"][n][keep], atol=1e-5,
                                   rtol=1e-4, err_msg=n)
    for k in ("valid", "exist_since", "adam_step"):
        np.testing.assert_array_equal(tt[k], tj[k])
    np.testing.assert_array_equal(tt["stats"]["denom"], tj["stats"]["denom"])
    np.testing.assert_array_equal(tt["stats"]["max_radii2d"],
                                  tj["stats"]["max_radii2d"])
    np.testing.assert_allclose(tt["stats"]["grad_accum"],
                               tj["stats"]["grad_accum"], rtol=2e-2,
                               atol=2e-4 * tj["stats"]["grad_accum"].max())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loss_decreases(backend):
    """Twin of tests/test_train_step.py::test_loss_decreases: 6 steps from
    the knn init, with the binning computed inside the step."""
    jst, gt = _scene()
    st = G.state_from_numpy(jax_state_tree(jst), device="cpu")
    view = torch_view(simple_view(width=W, height=H, fx=100.0, fy=100.0))
    cfg = RasterizeConfig(**SPAN, backend=backend)
    seen = []
    for i in range(6):
        st, aux = train_step(
            st, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, *_gt_args(gt, t_),
            float(min(i, 24)), 1.0, width=W, height=H, active_sh_degree=0,
            opt=OptimizationParams(**OPT_KW), cfg=cfg, max_per_tile=512)
        seen.append(float(aux.loss))
    assert all(math.isfinite(x) for x in seen)
    assert seen[-1] < seen[0]
    assert int(st.adam_step) == 6
    assert float(st.stats.denom.sum()) > 0
    assert float(st.stats.max_radii2d.max()) > 0


def test_padded_rows_stay_finite_and_untouched():
    """Invalid capacity slots keep their parameters and get finite (zero)
    moments through a step of the kernel path."""
    jst, gt = _scene(n=64, cap=128)
    st = G.state_from_numpy(jax_state_tree(jst), device="cpu")
    before = {n: getattr(st.params, n)[64:].clone() for n in G.GROUPS}
    view = torch_view(simple_view(width=W, height=H, fx=100.0, fy=100.0))
    st, aux = train_step(
        st, view.world_view, view.full_proj, view.cam_center, view.tan_fovx,
        view.tan_fovy, *_gt_args(gt, t_), 0.0, 1.0, width=W, height=H,
        active_sh_degree=3, opt=OptimizationParams(**OPT_KW),
        cfg=RasterizeConfig(**SPAN, backend="cuda"), max_per_tile=256)
    assert math.isfinite(float(aux.loss))
    for n in G.GROUPS:
        assert torch.isfinite(getattr(st.adam_m, n)).all(), n
        assert torch.equal(getattr(st.params, n)[64:], before[n]), n
        assert (getattr(st.adam_m, n)[64:] == 0).all(), n


def test_upsample_lf():
    """Half-pixel bilinear upsample of the encoder grid (the JAX test's
    constant field, plus a ramp checked against jax.image.resize)."""
    up = upsample_lf(torch.ones(37, 37, 8), H, W)
    assert up.shape == (H, W, 8)
    np.testing.assert_allclose(np_(up), 1.0, rtol=1e-5)
    ramp = np.random.default_rng(0).normal(size=(37, 37, 4)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(ramp), (H, W, 4), method="linear")
    np.testing.assert_allclose(np_(upsample_lf(t_(ramp), H, W)),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)
