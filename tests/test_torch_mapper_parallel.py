"""legslam_torch's GaussianMapper on its strip and multi-view ticks vs
legslam_tpu's, at 128x64 (the capacity-sharded tick, the slowest of the
three, is in tests/test_torch_mapper_store.py).

JAX sizes a mesh from conftest's 8 virtual CPU devices (2 devices for 2
views or 2 strips, 8 for the sharded store); the port has no process
group here, so it takes its one-device path: the views and the strips in
turn, the store whole. Both run their reference compositors ("xla",
"torch") over 5 frames, 2 iterations a frame and a tail of 4, with no
densify. The same keyframe picks; per-iteration losses rtol 1e-3; the
final valid mask exactly; the final parameters within the train step's
gradient tolerance (atol 2e-4 x the group's largest value, rtol 2e-2),
but for at most 1 element in 2000 of a group, each within 10
learning-rate steps (tests/test_torch_mapper.py's exception).
"""
import numpy as np
import pytest
import torch

from legslam_tpu.config import MapperParams as JaxMP
from legslam_tpu.config import OptimizationParams as JaxOpt
from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
from legslam_tpu.slam.trajectory import TrajectoryFrontend as JaxFrontend
from legslam_torch.config import MapperParams, OptimizationParams
from legslam_torch.config import RasterizeConfig
from legslam_torch.data.synthetic import SyntheticDataset
from legslam_torch.mapper.mapper import GaussianMapper
from legslam_torch.models import gaussians as G
from legslam_torch.slam.trajectory import TrajectoryFrontend

from .torch_parity import jax_state_tree

torch.set_num_threads(1)

W, H, N_FRAMES = 128, 64, 5
CFG_KW = dict(tile_h=16, tile_w=128, max_span_x=1, max_span_y=4, chunk=64,
              tile_batch=4)
OPT_KW = dict(densify_from_iter=1000, opacity_reset_interval=0,
              position_lr_init=0.0016, position_lr_final=1.6e-5)
MP_KW = dict(min_num_initial_map_kfs=2, depth_cache=2,
             do_gaus_pyramid_training=False)


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(n_frames=N_FRAMES, width=W, height=H,
                          n_gaussians=1200, seed=5, revolutions=0.2,
                          device="cpu")
    return [ds.read(i) for i in range(N_FRAMES)], ds.intrinsics


def _drive(mapper, frontend, frames):
    losses, picks = [], []
    pick = mapper._pick_keyframe

    def rec_pick():
        kf = pick()
        picks.append(None if kf is None else kf.fid)
        return kf
    mapper._pick_keyframe = rec_pick
    mapper.loss_sync_interval = 1
    for f in frames:
        frontend.track(f)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(2):
                losses.append(mapper.train_iteration())
    frontend.finish()
    mapper.drain_operations()
    for _ in range(4):
        losses.append(mapper.train_iteration())
    return losses, picks


@pytest.mark.parametrize("kw", [dict(spatial_strips=2), dict(n_views=2)],
                         ids=["strips", "views"])
def test_mapper_ticks_match_jax(frames, tmp_path, kw):
    check_ticks(frames, tmp_path, kw)


def check_ticks(frames, tmp_path, kw):
    """Both packages' mappers with `kw` over the frames, compared."""
    frames, intr = frames
    common = dict(capacity=1 << 12, max_per_tile=512,
                  include_lang_feat=False, seed=0, **kw)
    fj = JaxFrontend(intr, kf_stride=1, max_corners=200)
    mj = JaxMapper(fj.queue, intr, opt=JaxOpt(**OPT_KW), mp=JaxMP(**MP_KW),
                   cfg=JaxCfg(**CFG_KW), result_dir=str(tmp_path / "j"),
                   **common)
    ft = TrajectoryFrontend(intr, kf_stride=1, max_corners=200)
    mt = GaussianMapper(ft.queue, intr, opt=OptimizationParams(**OPT_KW),
                        mp=MapperParams(**MP_KW),
                        cfg=RasterizeConfig(**CFG_KW),
                        result_dir=str(tmp_path / "t"), device="cpu",
                        **common)
    assert mt._group is None and mt._view_group is None   # one device
    if "shard_store" in kw:
        assert mj._mesh is not None and mj._mesh.devices.size == 8
    lj, pj = _drive(mj, fj, frames)
    lt, pt = _drive(mt, ft, frames)
    assert pt == pj and None not in pt
    assert mt.iteration == mj.iteration == len(lt) > 8
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    tt, tj = G.state_to_numpy(mt.state), jax_state_tree(mj.state)
    np.testing.assert_array_equal(tt["valid"], tj["valid"])
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
    np.testing.assert_array_equal(tt["stats"]["denom"], tj["stats"]["denom"])
