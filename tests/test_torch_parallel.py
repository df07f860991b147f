"""legslam_torch's multi-view, strip and capacity-sharded steps vs
legslam_tpu's (parallel/sharded.py, spatial.py, capacity.py), in one
process: the port runs the views and the strips in turn on the CPU, JAX
on meshes of conftest's 8 virtual CPU devices.

Tolerances: the loss rtol 1e-4; the updated parameters atol 2e-5 / rtol
1e-3, but for at most 1 element in 1000 of a group, each within 2
learning-rate steps (Adam's first step moves an element by about lr *
sign(g), so where a gradient sits at rounding noise its sign can flip:
tests/test_torch_train_step.py's exception); the densify visit counts
exactly and the accumulated screen-gradient norms atol 1e-6 / rtol 1e-3.
Against the port's own one-view train_step the strip step takes
tests/test_spatial.py's tolerances (loss rtol 2e-6, colour / depth atol
1e-6, parameters atol 5e-5, denom exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import OptimizationParams as JaxOpt
from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.models import gaussians as JG
from legslam_tpu.parallel import capacity as JC
from legslam_tpu.parallel import sharded as JSH
from legslam_tpu.parallel import spatial as JSP
from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import train_step
from legslam_torch.models import gaussians as G
from legslam_torch.parallel import capacity, sharded, spatial

from .torch_parity import jax_state_tree, np_, t_, torch_view
from .util import simple_view

torch.set_num_threads(1)

W, H = 128, 88          # H not a tile multiple: the strips pad 88 -> 96
KW = dict(tile_h=16, tile_w=128, max_span_x=1, max_span_y=6, chunk=32,
          tile_batch=2, max_pairs=1 << 14)
LR = dict(xyz=0.00016, f_dc=0.0025, f_rest=0.000125, lang_feat=0.0025,
          opacity=0.05, scaling=0.005, rotation=0.001)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    n, cap = 96, 128
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.0
    st = JG.create_from_pcd(pts, rng.uniform(size=(n, 3)).astype(np.float32),
                            capacity=cap,
                            lang_feat=rng.normal(size=(n, 64))
                            .astype(np.float32))
    views = [simple_view(width=W, height=H, fx=60.0 + 4 * i, fy=60.0)
             for i in range(4)]
    B = len(views)
    gt = dict(gt_color=rng.uniform(size=(B, H, W, 3)),
              gt_lang_feat=rng.normal(size=(B, H, W, 64)),
              gt_depth=np.full((B, H, W), 2.5), mask=np.ones((B, H, W)))
    return st, views, {k: v.astype(np.float32) for k, v in gt.items()}


def _port_state(st):
    return G.state_from_numpy(jax_state_tree(st), device="cpu")


def _jax_batch(views, gt):
    return JSH.ViewBatch(
        world_view=jnp.stack([v.world_view for v in views]),
        full_proj=jnp.stack([v.full_proj for v in views]),
        cam_center=jnp.stack([v.cam_center for v in views]),
        tan_fovx=jnp.asarray([v.tan_fovx for v in views], jnp.float32),
        tan_fovy=jnp.asarray([v.tan_fovy for v in views], jnp.float32),
        **{k: jnp.asarray(v) for k, v in gt.items()})


def _port_batch(views, gt):
    return sharded.make_view_batch(
        [torch_view(v) for v in views], t_(gt["gt_color"]),
        t_(gt["gt_lang_feat"]), t_(gt["gt_depth"]), t_(gt["mask"]))


def _assert_states_close(st, jst):
    tt, tj = G.state_to_numpy(st), jax_state_tree(jst)
    for n in G.GROUPS:
        a, b = tt["params"][n], tj["params"][n]
        bad = ~np.isclose(a, b, atol=2e-5, rtol=1e-3)
        assert bad.mean() <= 1e-3, (n, bad.sum())
        assert np.all(np.abs(a - b)[bad] <= 2 * LR[n]), n
    np.testing.assert_array_equal(tt["stats"]["denom"], tj["stats"]["denom"])
    np.testing.assert_allclose(tt["stats"]["grad_accum"],
                               tj["stats"]["grad_accum"], atol=1e-6,
                               rtol=1e-3)
    np.testing.assert_array_equal(tt["stats"]["max_radii2d"],
                                  tj["stats"]["max_radii2d"])
    assert int(st.adam_step) == int(jst.adam_step) == 1


def test_batched_step_matches_jax_mesh(scene):
    """Two views: JAX on a 2-device mesh, the port in turn."""
    jst, views, gt = scene
    views, gt = views[:2], {k: v[:2] for k, v in gt.items()}
    mesh = JSH.make_mesh(2)
    jst2, jaux = JSH.batched_train_step(
        JSH.replicate_state(jst, mesh),
        JSH.shard_batch(_jax_batch(views, gt), mesh), jnp.zeros(3),
        jnp.asarray(0.0), 1.0, width=W, height=H, active_sh_degree=0,
        opt=JaxOpt(), cfg=JaxCfg(**KW), max_per_tile=128)
    st, aux = sharded.batched_train_step(
        _port_state(jst), _port_batch(views, gt), torch.zeros(3), 0.0, 1.0,
        width=W, height=H, active_sh_degree=0, opt=OptimizationParams(),
        cfg=RasterizeConfig(**KW), max_per_tile=128)
    np.testing.assert_allclose(float(aux.loss), float(jaux.loss), rtol=1e-4)
    np.testing.assert_allclose(float(aux.psnr), float(jaux.psnr), rtol=1e-4)
    np.testing.assert_allclose(np_(aux.color), np.asarray(jaux.color),
                               atol=1e-5)
    _assert_states_close(st, jst2)


def test_batched_step_of_one_view_is_train_step(scene):
    """n_views=1: the batched step is the one-view step, bit for bit."""
    jst, views, gt = scene
    v = torch_view(views[0])
    st_b, aux_b = sharded.batched_train_step(
        _port_state(jst), _port_batch(views[:1], {k: x[:1] for k, x in
                                                  gt.items()}),
        torch.zeros(3), 0.0, 1.0, width=W, height=H, active_sh_degree=0,
        opt=OptimizationParams(), cfg=RasterizeConfig(**KW),
        max_per_tile=128)
    st_s, aux_s = train_step(
        _port_state(jst), v.world_view, v.full_proj, v.cam_center,
        v.tan_fovx, v.tan_fovy, *(t_(gt[k][0]) for k in
                                  ("gt_color", "gt_lang_feat", "gt_depth",
                                   "mask")),
        torch.zeros(3), 0.0, 1.0, width=W, height=H, active_sh_degree=0,
        opt=OptimizationParams(), cfg=RasterizeConfig(**KW),
        max_per_tile=128)
    np.testing.assert_array_equal(np_(aux_b.loss), np_(aux_s.loss))
    for x, y in zip(G.state_tensors(st_b), G.state_tensors(st_s)):
        np.testing.assert_array_equal(np_(x), np_(y))


def _spatial_inputs(gt, layout, v=0):
    pads = [spatial.pad_rows(t_(gt[k][v]), layout.h_padded)
            for k in ("gt_color", "gt_lang_feat", "gt_depth", "mask")]
    return pads


@pytest.mark.parametrize("n_strips", [2, 3])
def test_spatial_step_matches_jax_and_train_step(scene, n_strips):
    jst, views, gt = scene
    jview, view = views[0], torch_view(views[0])
    layout = spatial.spatial_layout(H, KW["tile_h"], n_strips)
    jl = JSP.spatial_layout(H, KW["tile_h"], n_strips)
    assert tuple(layout) == tuple(jl)
    jpads = [JSP.pad_rows(jnp.asarray(gt[k][0]), jl.h_padded)
             for k in ("gt_color", "gt_lang_feat", "gt_depth", "mask")]
    jst2, jaux = JSP.spatial_train_step(
        jst, jview.world_view, jview.full_proj, jview.cam_center,
        jview.tan_fovx, jview.tan_fovy, *jpads, jnp.zeros(3),
        jnp.asarray(0.0), 1.0, JSP.strip_offsets(jl), width=W, height=H,
        h_local=jl.h_local, active_sh_degree=0, opt=JaxOpt(),
        cfg=JaxCfg(**KW), max_per_tile=128)
    pads = _spatial_inputs(gt, layout)
    cys = spatial.strip_offsets(layout)
    np.testing.assert_array_equal(np_(cys), np.asarray(
        JSP.strip_offsets(jl)))
    st, aux = spatial.spatial_train_step(
        _port_state(jst), view.world_view, view.full_proj, view.cam_center,
        view.tan_fovx, view.tan_fovy, *pads, torch.zeros(3), 0.0, 1.0, cys,
        width=W, height=H, h_local=layout.h_local, active_sh_degree=0,
        opt=OptimizationParams(), cfg=RasterizeConfig(**KW),
        max_per_tile=128)
    np.testing.assert_allclose(float(aux.loss), float(jaux.loss), rtol=1e-4)
    np.testing.assert_allclose(np_(aux.color), np.asarray(jaux.color),
                               atol=1e-5)
    _assert_states_close(st, jst2)
    # and the port's one-view step on the same view
    st_s, aux_s = train_step(
        _port_state(jst), view.world_view, view.full_proj, view.cam_center,
        view.tan_fovx, view.tan_fovy, *(t_(gt[k][0]) for k in
                                        ("gt_color", "gt_lang_feat",
                                         "gt_depth", "mask")),
        torch.zeros(3), 0.0, 1.0, width=W, height=H, active_sh_degree=0,
        opt=OptimizationParams(), cfg=RasterizeConfig(**KW),
        max_per_tile=128)
    np.testing.assert_allclose(float(aux.loss), float(aux_s.loss),
                               rtol=2e-6)
    np.testing.assert_allclose(np_(aux.color), np_(aux_s.color), atol=1e-6)
    np.testing.assert_allclose(np_(aux.depth), np_(aux_s.depth), atol=1e-6)
    for n in G.GROUPS:
        np.testing.assert_allclose(np_(getattr(st.params, n)),
                                   np_(getattr(st_s.params, n)), atol=5e-5,
                                   err_msg=n)
    np.testing.assert_array_equal(np_(st.stats.denom), np_(st_s.stats.denom))


def test_spatial_cached_binning_equals_fresh(scene):
    jst, views, gt = scene
    view = torch_view(views[0])
    layout = spatial.spatial_layout(H, KW["tile_h"], 2)
    cys = spatial.strip_offsets(layout)
    cfg = RasterizeConfig(**KW)
    st0 = _port_state(jst)
    p = st0.params
    binning = spatial.spatial_compute_binning(
        p.xyz, torch.exp(p.scaling), p.rotation, st0.valid, view.world_view,
        view.full_proj, view.tan_fovx, view.tan_fovy, cys, width=W,
        height=H, h_local=layout.h_local, cfg=cfg, max_per_tile=128,
        opacity=torch.sigmoid(p.opacity[:, 0]))
    out = []
    for b in (binning, None):
        out.append(spatial.spatial_train_step(
            _port_state(jst), view.world_view, view.full_proj,
            view.cam_center, view.tan_fovx, view.tan_fovy,
            *_spatial_inputs(gt, layout), torch.zeros(3), 0.0, 1.0, cys,
            width=W, height=H, h_local=layout.h_local, active_sh_degree=0,
            opt=OptimizationParams(), cfg=cfg, max_per_tile=128,
            binning=b))
    (s1, a1), (s2, a2) = out
    np.testing.assert_array_equal(np_(a1.loss), np_(a2.loss))
    for x, y in zip(G.state_tensors(s1), G.state_tensors(s2)):
        np.testing.assert_array_equal(np_(x), np_(y))


def test_spatial_batched_matches_jax_2d_mesh(scene):
    """4 views x 2 strips: JAX on a ('data', 'strip') mesh of 8 devices,
    the port in turn; and the port's own batched step on the same views."""
    jst, views, gt = scene
    mesh = JSP.make_mesh2d(4, 2)
    jl = JSP.spatial_layout(H, KW["tile_h"], 2)
    jb = _jax_batch(views, gt)
    pad = jax.vmap(lambda x: JSP.pad_rows(x, jl.h_padded))
    jb = jb._replace(gt_color=pad(jb.gt_color),
                     gt_lang_feat=pad(jb.gt_lang_feat),
                     gt_depth=pad(jb.gt_depth), mask=pad(jb.mask))
    jst2, jaux = JSP.spatial_batched_train_step(
        JSH.replicate_state(jst, mesh), JSP.shard_batch_rows(jb, mesh),
        jnp.zeros(3), jnp.asarray(0.0), 1.0, JSP.strip_offsets(jl),
        width=W, height=H, h_local=jl.h_local, active_sh_degree=0,
        opt=JaxOpt(), cfg=JaxCfg(**KW), max_per_tile=128)
    layout = spatial.spatial_layout(H, KW["tile_h"], 2)
    b = _port_batch(views, gt)
    bp = b._replace(**{k: torch.stack([spatial.pad_rows(x, layout.h_padded)
                                       for x in getattr(b, k)])
                       for k in ("gt_color", "gt_lang_feat", "gt_depth",
                                 "mask")})
    st, aux = spatial.spatial_batched_train_step(
        _port_state(jst), bp, torch.zeros(3), 0.0, 1.0,
        spatial.strip_offsets(layout), width=W, height=H,
        h_local=layout.h_local, active_sh_degree=0,
        opt=OptimizationParams(), cfg=RasterizeConfig(**KW),
        max_per_tile=128)
    np.testing.assert_allclose(float(aux.loss), float(jaux.loss), rtol=1e-4)
    np.testing.assert_allclose(np_(aux.color), np.asarray(jaux.color),
                               atol=1e-5)
    _assert_states_close(st, jst2)
    st_b, aux_b = sharded.batched_train_step(
        _port_state(jst), b, torch.zeros(3), 0.0, 1.0, width=W, height=H,
        active_sh_degree=0, opt=OptimizationParams(),
        cfg=RasterizeConfig(**KW), max_per_tile=128)
    np.testing.assert_allclose(float(aux.loss), float(aux_b.loss),
                               rtol=2e-6)
    np.testing.assert_array_equal(np_(st.stats.denom),
                                  np_(st_b.stats.denom))


def test_shard_state_layout_matches_jax():
    """Rank r's rows of every capacity-leading leaf are JAX's shard r of
    capacity.shard_state on an 8-device mesh; scalars replicate."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    jst = JG.create_from_pcd(pts, rng.uniform(size=(100, 3)), 1 << 10)
    js = JC.shard_state(jst, JSH.make_mesh(8))
    st = _port_state(jst)
    for r in range(8):
        mine = G.map_rows(st, lambda t: capacity.rows_of(t, 8, r))
        assert mine.capacity == (1 << 10) // 8
        want = jax.tree.map(lambda x: np.asarray(
            x.addressable_shards[r].data), js)
        got = jax_state_tree(want)
        for n in G.GROUPS:
            np.testing.assert_array_equal(np_(getattr(mine.params, n)),
                                          got["params"][n], err_msg=n)
        np.testing.assert_array_equal(np_(mine.valid), got["valid"])
        assert int(mine.adam_step) == int(got["adam_step"])
    assert capacity.shard_state(st, None) is st
    # the rows split 8 ways; the two int32 scalars are whole on each
    scalars = 2 * 4
    assert capacity.shard_bytes_per_device(mine) - scalars == \
        (capacity.shard_bytes_per_device(st) - scalars) // 8


def test_densification_stats_batched_matches_jax(scene):
    """add_densification_stats_batched (the per-view visits of the
    multi-view step) against JAX's on seeded per-view gradients and radii:
    visit counts and max radii exactly, the norms rtol 1e-6."""
    jst = scene[0]
    rng = np.random.default_rng(4)
    cap = jst.capacity
    g = rng.normal(size=(3, cap, 2)).astype(np.float32)
    r = rng.integers(-1, 4, size=(3, cap)).astype(np.int32)
    jout = JG.add_densification_stats_batched(jst, jnp.asarray(g),
                                              jnp.asarray(r))
    st = G.add_densification_stats_batched(_port_state(jst), t_(g), t_(r))
    tj, tt = jax_state_tree(jout)["stats"], G.state_to_numpy(st)["stats"]
    np.testing.assert_array_equal(tt["denom"], tj["denom"])
    np.testing.assert_array_equal(tt["max_radii2d"], tj["max_radii2d"])
    np.testing.assert_allclose(tt["grad_accum"], tj["grad_accum"], rtol=1e-6)
    assert tt["denom"].max() == 3
