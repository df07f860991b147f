"""legslam_torch's online mapper slice vs legslam_tpu's, at 128x64.

* build_keyframe: every pyramid level. The sub-levels are resized with
  cv2's INTER_LINEAR semantics (cv2 is installed here, so the JAX module
  uses it); the port's torch resize agrees to an ulp at the pyramid's
  exact halvings, so the 8-bit color and u16-millimetre depth agree but
  for the rare value that rounds across a quantisation step (at most one
  step, on < 0.5% of the values).
* SyntheticDataset: frames to atol 2e-5 / rtol 1e-4, except pixels where
  the hit probability lies within 1e-4 of the 0.5 depth-validity
  threshold (at most 8 a frame).
* TrajectoryFrontend: the operation stream, identical.
* GaussianMapper: 6 frames, capacity 2^12, refresh 2 with both trims, a
  span cap that escalates, one clone-only densify. JAX runs its Pallas
  kernels in interpret mode with pallas_sort; the port runs the "cuda"
  backend with cuda_sort (the kernels' plain versions on the CPU). The
  same keyframe picks, invalidation points and escalations; per-iteration
  losses rtol 1e-3; the final valid mask exactly; the final parameters
  within the train step's gradient tolerance (atol 2e-4 x the group's
  largest value, rtol 2e-2), but for at most 1 element in 2000 of a
  group, each within 10 learning-rate steps of JAX's: Adam moves an
  element by about one learning rate a step whatever its gradient, so
  where a gradient is near zero, rounding can flip the sign of a step
  (the exception of tests/test_torch_train_step.py, which holds per-step
  gradients the mapper does not expose).
"""
import dataclasses

import numpy as np
import pytest
import torch

from legslam_tpu.config import MapperParams as JaxMP
from legslam_tpu.config import OptimizationParams as JaxOpt
from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from legslam_tpu.mapper import keyframe as JK
from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
from legslam_tpu.slam.trajectory import TrajectoryFrontend as JaxFrontend
from legslam_torch.config import MapperParams, OptimizationParams
from legslam_torch.config import RasterizeConfig
from legslam_torch.data.synthetic import SyntheticDataset
from legslam_torch.mapper import keyframe as TK
from legslam_torch.mapper.mapper import GaussianMapper
from legslam_torch.slam.trajectory import TrajectoryFrontend

from .torch_parity import jax_state_tree, np_

torch.set_num_threads(1)

W, H, N_FRAMES = 128, 64, 6
SCENE = dict(n_frames=N_FRAMES, width=W, height=H, n_gaussians=1500, seed=3,
             revolutions=0.2)


@pytest.fixture(scope="module")
def frames():
    """The port's synthetic frames: the common input of both packages in
    the keyframe, frontend and mapper checks."""
    ds = SyntheticDataset(**SCENE, device="cpu")
    return [ds.read(i) for i in range(N_FRAMES)], ds.intrinsics


def test_synthetic_frames_match(frames):
    frames, intr = frames
    ds = JaxSynthetic(**SCENE)
    assert ds.intrinsics == intr
    for i in (0, N_FRAMES - 1):
        t, j = frames[i], ds.read(i)
        np.testing.assert_array_equal(t.c2w, j.c2w)
        np.testing.assert_allclose(t.color, j.color, atol=2e-5, rtol=1e-4)
        bad = ~np.isclose(t.depth, j.depth, atol=2e-5, rtol=1e-4)
        assert bad.sum() <= 8, bad.sum()
        # a flipped pixel is one whose hit probability sits at the 0.5
        # threshold: valid on one side, a hole (0) on the other
        assert np.all((t.depth[bad] == 0) | (j.depth[bad] == 0))


def _packet(frames, intr, i=2):
    fe = JaxFrontend(intr, kf_stride=1, max_corners=200)
    return fe.track(frames[i], lf_image=np.random.default_rng(0).normal(
        size=(37, 37, 64)).astype(np.float32))


@pytest.mark.parametrize("sub_levels", [2, 0])
def test_build_keyframe_matches(frames, sub_levels):
    frames, intr = frames
    pk = _packet(frames, intr)
    mask = np.ones((H, W), np.float32)
    mask[:, :3] = 0.25      # a mask that is not all ones is uploaded
    kj = JK.build_keyframe(pk, intr, sub_levels, (8, 8), 8, 5,
                           mask_full=mask)
    kt = TK.build_keyframe(pk, intr, sub_levels, (8, 8), 8, 5,
                           mask_full=mask, device="cpu")
    assert len(kt.views) == len(kj.views) == sub_levels + 1
    for lvl in range(sub_levels + 1):
        vt, vj = kt.views[lvl], kj.views[lvl]
        assert (vt.width, vt.height, vt.fovx, vt.fovy) == \
            (vj.width, vj.height, vj.fovx, vj.fovy)
        np.testing.assert_allclose(np_(vt.full_proj), np.asarray(
            vj.full_proj), rtol=1e-6)
        for got, want, step in ((kt.gt_color[lvl], kj.gt_color[lvl], 1 / 255),
                                (kt.gt_depth[lvl], kj.gt_depth[lvl], 1e-3),
                                (kt.mask[lvl], kj.mask[lvl], 1e-6)):
            d = np.abs(np_(got) - np.asarray(want))
            assert d.max() <= step * 1.001 and (d > 0).mean() < 5e-3
        if lvl == sub_levels:       # full resolution: not resized
            np.testing.assert_array_equal(np_(kt.gt_color[lvl]),
                                          np.asarray(kj.gt_color[lvl]))
            np.testing.assert_array_equal(np_(kt.gt_depth[lvl]),
                                          np.asarray(kj.gt_depth[lvl]))
    np.testing.assert_array_equal(np_(kt.gt_lf), np.asarray(kj.gt_lf))
    assert kt.pyramid_uses == kj.pyramid_uses
    assert [kt.pick_pyramid_level() for _ in range(20)] == \
        [kj.pick_pyramid_level() for _ in range(20)]


def test_trajectory_frontend_stream_matches(frames):
    frames, intr = frames
    fj = JaxFrontend(intr, kf_stride=2, max_corners=200)
    ft = TrajectoryFrontend(intr, kf_stride=2, max_corners=200)
    for f in frames:
        fj.track(f)
        ft.track(f)
    n = 0
    while True:
        oj, ot = fj.queue.pop_operation(), ft.queue.pop_operation()
        assert (oj is None) == (ot is None)
        if oj is None:
            break
        n += 1
        assert ot.kind == oj.kind and ot.scale == oj.scale
        np.testing.assert_array_equal(ot.points_xyz, oj.points_xyz)
        np.testing.assert_array_equal(ot.points_color, oj.points_color)
        for a, b in zip(ot.keyframes, oj.keyframes):
            for field in dataclasses.fields(b):
                x, y = getattr(a, field.name), getattr(b, field.name)
                if isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=field.name)
                else:
                    assert x == y, field.name
    assert n == N_FRAMES // 2
    assert ft.queue.live_keyframe_ids() == fj.queue.live_keyframe_ids()


# --- the mapper --------------------------------------------------------------

CFG_KW = dict(tile_h=16, tile_w=128, max_span_x=1, max_span_y=2, chunk=64,
              tile_batch=4, max_pairs=1 << 13)
OPT_KW = dict(densify_from_iter=8, densification_interval=12,
              opacity_reset_interval=0, percent_dense=1e3,
              densify_grad_threshold=2e-5, position_lr_init=0.0016,
              position_lr_final=1.6e-5)
MP_KW = dict(min_num_initial_map_kfs=2, depth_cache=2,
             do_gaus_pyramid_training=False)
ITERS_PER_FRAME = 3
TAIL = 6


def _drive(mapper, frontend, frames, lf_images=None):
    """The app loop (apps/replica_rgbd.py): track (with an LF image a
    frame when given), drain, initialise, train; then the tail. Returns
    the per-iteration losses and keyframe picks, the iterations at which
    the binning cache was dropped, and the (iteration, valid before,
    valid after) of each densify step."""
    losses, picks, invalid, densified = [], [], [], []
    pick, inval = mapper._pick_keyframe, mapper._invalidate_binning
    post = mapper._post_step_densify

    def rec_post():
        n0 = int(mapper.state.num_valid())
        post()
        n1 = int(mapper.state.num_valid())
        if n1 != n0:
            densified.append((mapper.iteration, n0, n1))

    def rec_pick():
        kf = pick()
        picks.append(None if kf is None else kf.fid)
        return kf

    def rec_inval():
        invalid.append(mapper.iteration)
        inval()
    mapper._pick_keyframe, mapper._invalidate_binning = rec_pick, rec_inval
    mapper._post_step_densify = rec_post
    mapper.loss_sync_interval = 1
    for i, f in enumerate(frames):
        frontend.track(f, lf_image=None if lf_images is None
                       else lf_images[i])
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(ITERS_PER_FRAME):
                losses.append(mapper.train_iteration())
    frontend.finish()
    mapper.drain_operations()
    for _ in range(TAIL):
        losses.append(mapper.train_iteration())
    return losses, picks, invalid, densified


@pytest.fixture(scope="module")
def mapper_runs(frames, tmp_path_factory):
    frames, intr = frames
    kw = dict(capacity=1 << 12, max_per_tile=512, include_lang_feat=False,
              binning_refresh_interval=2, seed=0)
    fj = JaxFrontend(intr, kf_stride=1, max_corners=200)
    mj = JaxMapper(fj.queue, intr, opt=JaxOpt(**OPT_KW), mp=JaxMP(**MP_KW),
                   cfg=JaxCfg(**CFG_KW, backend="pallas",
                              pallas_interpret=True, pallas_sort=True),
                   result_dir=str(tmp_path_factory.mktemp("jax")), **kw)
    ft = TrajectoryFrontend(intr, kf_stride=1, max_corners=200)
    mt = GaussianMapper(ft.queue, intr, opt=OptimizationParams(**OPT_KW),
                        mp=MapperParams(**MP_KW),
                        cfg=RasterizeConfig(**CFG_KW, backend="cuda",
                                            cuda_sort=True),
                        result_dir=str(tmp_path_factory.mktemp("torch")),
                        device="cpu", **kw)
    return (_drive(mj, fj, frames), mj), (_drive(mt, ft, frames), mt)


def test_mapper_schedule_matches(mapper_runs):
    ((lj, pj, ij, dj), mj), ((lt, pt, it, dt), mt) = mapper_runs
    assert pt == pj and None not in pt
    assert it == ij
    assert mt.overflow_escalations == mj.overflow_escalations
    assert mt.overflow_escalations, "the span cap should escalate"
    assert mt.cfg == RasterizeConfig(**dict(CFG_KW, max_span_y=4),
                                     backend="cuda", cuda_sort=True)
    assert mt.iteration == mj.iteration == len(lt)
    # one clone-only densify, which grew the store the same on both sides
    assert dt == dj and len(dt) == 1 and dt[0][2] > dt[0][1]
    assert dt[0][0] == OPT_KW["densification_interval"]
    assert mt.fresh_binnings >= mt.iteration // 2
    np.testing.assert_allclose(lt, lj, rtol=1e-3)


def test_mapper_final_state_matches(mapper_runs):
    (_, mj), (_, mt) = mapper_runs
    tj = jax_state_tree(mj.state)
    from legslam_torch.models import gaussians as G
    tt = G.state_to_numpy(mt.state)
    np.testing.assert_array_equal(tt["valid"], tj["valid"])
    np.testing.assert_array_equal(tt["exist_since"], tj["exist_since"])
    opt = mt.opt
    lr = dict(xyz=opt.position_lr_init * mt.cameras_extent,
              f_dc=opt.feature_lr, f_rest=opt.feature_lr / 20,
              lang_feat=opt.lang_feature_lr, opacity=opt.opacity_lr,
              scaling=opt.scaling_lr, rotation=opt.rotation_lr)
    for n in G.GROUPS:
        a, b = tt["params"][n], tj["params"][n]
        bad = ~np.isclose(a, b, atol=2e-4 * np.abs(b).max(), rtol=2e-2)
        assert bad.mean() <= 5e-4, (n, bad.sum())
        assert np.all(np.abs(a - b)[bad] <= 10 * lr[n]), n
    assert mt.active_sh_degree == mj.active_sh_degree
    assert sorted(mt.keyframes) == sorted(mj.keyframes)


@pytest.mark.parametrize("kw", [dict(n_views=2), dict(spatial_strips=2),
                                dict(shard_store=True)])
def test_unported_mapper_paths_raise(kw):
    """The multi-view, spatial and sharded paths are ported now (they
    were the last that raised): each constructs and, with no process
    group, takes the one-device path, leaving the capacity ladder off as
    JAX does. Their ticks are held against JAX's mapper in
    tests/test_torch_mapper_parallel.py and test_torch_mapper_store.py.
    (The mono / stereo inactive geometry is held against JAX in
    tests/test_torch_stereo.py.)"""
    from legslam_torch.slam.interface import OperationQueue
    intr = dict(width=W, height=H, fx=100.0, fy=100.0, cx=63.5, cy=31.5)
    m = GaussianMapper(OperationQueue(), intr, device="cpu", **kw)
    assert m._group is None and m._view_group is None
    assert m._shard_group is None and not m.capacity_ladder
    for bad in (dict(n_views=0), dict(spatial_strips=0)):
        with pytest.raises(ValueError):
            GaussianMapper(OperationQueue(), intr, device="cpu", **bad)