"""legslam_torch's watermark slab skip, crop renders and dense oracle vs
legslam_tpu's.

* watermark / prefix_rows / prefix_map against JAX's watermark and
  prefix_map (the same whole-slab prefix, the same values, gradients zero
  above it);
* train_step with p_slabs=8 against p_slabs=0 on a store with interior
  holes and a dead tail of stale rows: loss, the updated store and the
  statistics bit for bit (every slabbed segment is rowwise, so its rows
  compute what the full pass computes), and adam_update /
  add_densification_stats with n_slabs likewise;
* render_arrays with crop_y / crop_h against JAX's, strip by strip: the
  "torch" compositor against "xla" and the "cuda" path's plain versions
  against the Pallas kernels in interpret mode, at the forward tolerances
  (atol 3e-5 / rtol 1e-3, LF 2e-4); each strip also equals the rows of
  the port's full render to 1e-5;
* rasterize_oracle against JAX's, atol 1e-5 (the same dense formulation
  in float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.ops import slabs as JS
from legslam_tpu.ops.oracle import rasterize_oracle as jax_oracle
from legslam_tpu.ops.projection import preprocess as jax_preprocess
from legslam_tpu.ops.rasterize import render_arrays as jax_render
from legslam_tpu.utils.sh import sh_to_color as jax_sh_to_color
from legslam_tpu.utils.transforms import normalize_quat as jax_nq
from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import train_step
from legslam_torch.models import gaussians as G
from legslam_torch.ops import slabs as TS
from legslam_torch.ops.oracle import rasterize_oracle
from legslam_torch.ops.projection import preprocess
from legslam_torch.ops.rasterize import render_arrays
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.sh import sh_to_color
from legslam_torch.utils.transforms import normalize_quat

from .torch_parity import assert_close, np_, t_, torch_view
from .util import random_scene, simple_view

torch.set_num_threads(1)

CAP, LIVE = 64, 37   # watermark 37: the first 5 of 8 slabs


@pytest.mark.parametrize("rows", [[0, 3, 9], [], [15], list(range(16))])
def test_watermark_and_prefix_match_jax(rows):
    v = np.zeros(16, bool)
    v[rows] = True
    hi_j = int(JS.watermark(jnp.asarray(v)))
    hi_t = TS.watermark(t_(v))
    assert int(hi_t) == hi_j
    x = np.arange(16.0, dtype=np.float32)
    yj = JS.prefix_map(lambda a: a * a, jnp.zeros_like, jnp.asarray(x),
                       jnp.int32(hi_j), 4)
    xt = t_(x).requires_grad_(True)
    yt = TS.prefix_map(lambda a: a["x"] * a["x"],
                       lambda a: torch.zeros_like(a["x"]), dict(x=xt),
                       hi_t, 4)
    np.testing.assert_array_equal(np_(yt), np.asarray(yj))
    m = TS.prefix_rows(hi_t, 16, 4)
    assert m == max(-(-hi_j // 4), 1) * 4
    yt.sum().backward()
    np.testing.assert_array_equal(np_(xt.grad)[m:], 0.0)
    np.testing.assert_array_equal(np_(xt.grad)[:m], 2 * x[:m])


def _holey_store():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, size=(LIVE, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(1.0, 4.0, size=LIVE).astype(np.float32)
    st = G.create_from_pcd(pts, rng.uniform(size=(LIVE, 3)), CAP,
                           lang_feat=rng.normal(size=(LIVE, 64)),
                           device="cpu")
    # interior holes below the watermark (pruned: zero moments) and a dead
    # tail of stale params: the skip must still be exact
    st.valid[[5, 19]] = False
    st.params.xyz[LIVE:] = t_(rng.uniform(-1, 1, size=(CAP - LIVE, 3)))
    st.params.xyz[LIVE:, 2] = 2.0
    view = CameraView.create(np.eye(3), np.zeros(3), 128, 48, fx=60.0,
                             fy=60.0, device="cpu")
    gt = dict(gt_color=t_(rng.uniform(size=(48, 128, 3)).astype(np.float32)),
              gt_lang_feat=t_(rng.normal(size=(48, 128, 64))
                              .astype(np.float32)),
              gt_depth=torch.full((48, 128), 2.5),
              mask=torch.ones(48, 128), bg=torch.zeros(3))
    return st, view, gt


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_train_step_p_slabs_exact(backend):
    """p_slabs=8 against p_slabs=0: two steps, bit for bit."""
    out = []
    for ps in (0, 8):
        st, view, gt = _holey_store()
        cfg = RasterizeConfig(tile_w=128, tile_h=16, chunk=64,
                              max_pairs=1 << 12, backend=backend,
                              p_slabs=ps)
        for i in range(2):
            st, aux = train_step(
                st, view.world_view, view.full_proj, view.cam_center,
                view.tan_fovx, view.tan_fovy, gt["gt_color"],
                gt["gt_lang_feat"], gt["gt_depth"], gt["mask"], gt["bg"],
                float(i + 1), 1.0, width=128, height=48, active_sh_degree=0,
                opt=OptimizationParams(), cfg=cfg, max_per_tile=512)
        out.append((st, aux))
    (s0, a0), (s1, a1) = out
    assert int(a0.num_rendered) > 0
    np.testing.assert_array_equal(np_(a1.loss), np_(a0.loss))
    np.testing.assert_array_equal(np_(a1.color), np_(a0.color))
    for x, y in zip(G.state_tensors(s1), G.state_tensors(s0)):
        np.testing.assert_array_equal(np_(x), np_(y))


def test_adam_and_stats_n_slabs_exact():
    st, _, _ = _holey_store()
    rng = np.random.default_rng(0)
    grads = G.GaussianParams(**{
        k: t_(rng.normal(size=v.shape).astype(np.float32))
        * st.valid.view((-1,) + (1,) * (v.ndim - 1))
        for k, v in st.params.as_dict().items()})
    lrs = dict(xyz=1e-3, f_dc=2e-3, f_rest=1e-4, lang_feat=5e-3,
               opacity=5e-2, scaling=5e-3, rotation=1e-3)
    mg = t_(rng.normal(size=(CAP, 2)).astype(np.float32))
    radii = torch.where(st.valid, t_(rng.integers(0, 5, CAP)), 0)
    ref, got = G.copy_state(st), G.copy_state(st)
    G.adam_update(ref, grads, lrs)
    G.add_densification_stats(ref, mg, radii)
    G.adam_update(got, grads, lrs, n_slabs=8)
    G.add_densification_stats(got, mg, radii, n_slabs=8,
                              watermark_hint=LIVE)
    for x, y in zip(G.state_tensors(got), G.state_tensors(ref)):
        np.testing.assert_array_equal(np_(x), np_(y))


@pytest.fixture(scope="module")
def crop_scene():
    rng = np.random.default_rng(5)
    scene = random_scene(rng, n=150, capacity=160, lf_dim=64)
    return scene, simple_view(width=128, height=64, fx=60.0, fy=60.0)


def _both_args(scene, jview, cfg_t, cfg_j):
    view = torch_view(jview)
    keys = ("means3d", "sh", "lang_feat", "opacity", "scales", "quats",
            "valid")
    jargs = tuple(jnp.asarray(scene[k]) for k in keys) + (
        jview.world_view, jview.full_proj, jview.cam_center, jview.tan_fovx,
        jview.tan_fovy, jview.width, jview.height, jnp.zeros(3), 3, cfg_j)
    targs = tuple(t_(scene[k]) for k in keys) + (
        view.world_view, view.full_proj, view.cam_center, view.tan_fovx,
        view.tan_fovy, view.width, view.height, torch.zeros(3), 3, cfg_t)
    return jargs, targs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_crop_render_matches_jax(crop_scene, backend):
    scene, jview = crop_scene
    kw = dict(tile_h=16, tile_w=128, max_span_x=1, max_span_y=4, chunk=32,
              tile_batch=2, max_pairs=1 << 12)
    cfg_t = RasterizeConfig(**kw, backend=backend)
    cfg_j = JaxCfg(**kw, backend="pallas" if backend == "cuda" else "xla",
                   pallas_interpret=True)
    jargs, targs = _both_args(scene, jview, cfg_t, cfg_j)
    full = render_arrays(*targs, max_per_tile=512)
    assert int(full.overflow_pairs) == 0
    for y0 in (0.0, 32.0):
        jo = jax_render(*jargs, max_per_tile=512, crop_y=jnp.float32(y0),
                        crop_h=32)
        to = render_arrays(*targs, max_per_tile=512, crop_y=y0, crop_h=32)
        assert to.color.shape == (32, 128, 3)
        for name in ("color", "depth", "final_t"):
            assert_close(getattr(to, name), getattr(jo, name), 3e-5, 1e-3,
                         name)
        assert_close(to.lang_feat, jo.lang_feat, 2e-4, 1e-3, "lf")
        assert int(to.num_rendered) == int(jo.num_rendered)
        rows = slice(int(y0), int(y0) + 32)
        assert_close(to.color, full.color[rows], 1e-5, 0, "strip color")
        assert_close(to.depth, full.depth[rows], 1e-5, 0, "strip depth")


def test_oracle_matches_jax(crop_scene):
    scene, jview = crop_scene
    view = torch_view(jview)
    cfg_j = JaxCfg(tile_h=16, tile_w=128)
    cfg_t = RasterizeConfig(tile_h=16, tile_w=128)
    w, h = jview.width, jview.height
    jpre = jax_preprocess(
        jnp.asarray(scene["means3d"]), jnp.asarray(scene["scales"]),
        jax_nq(jnp.asarray(scene["quats"])), jnp.asarray(scene["valid"]),
        jview.world_view, jview.full_proj, w, h, jview.focal_x,
        jview.focal_y, jview.tan_fovx, jview.tan_fovy)
    jrgb = jax_sh_to_color(3, jnp.asarray(scene["sh"]),
                           jnp.asarray(scene["means3d"]), jview.cam_center)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    jo = jax_oracle(jpre, jrgb, jnp.asarray(scene["opacity"]),
                    jnp.asarray(bg), w, h, cfg_j,
                    lang_feat=jnp.asarray(scene["lang_feat"]))
    pre = preprocess(t_(scene["means3d"]), t_(scene["scales"]),
                     normalize_quat(t_(scene["quats"])), t_(scene["valid"]),
                     view.world_view, view.full_proj, w, h, view.focal_x,
                     view.focal_y, view.tan_fovx, view.tan_fovy)
    rgb = sh_to_color(3, t_(scene["sh"]), t_(scene["means3d"]),
                      view.cam_center)
    to = rasterize_oracle(pre, rgb, t_(scene["opacity"]), t_(bg), w, h,
                          cfg_t, lang_feat=t_(scene["lang_feat"]))
    for name in ("color", "depth", "final_t", "lang_feat"):
        assert_close(getattr(to, name), getattr(jo, name), 1e-5, 1e-5, name)
    np.testing.assert_array_equal(np_(to.radii), np.asarray(jo.radii))
    assert float(to.final_t.min()) < 0.9
