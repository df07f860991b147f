"""A short GaussianMapper run on lens-distorted frames, legslam_torch
against legslam_tpu, on the CPU: 3 frames at 160x120 with the
radial-tangential distortion of tests/test_undistort.py, driven as
tests/test_torch_mapper.py drives its mapper case (JAX in interpret mode
with pallas_sort, the port on the "cuda" backend with cuda_sort: the
kernels' plain versions on the CPU), with a fresh binning every step.
Both mappers undistort each keyframe and gate the loss with the valid
mask. Per-iteration losses rtol 1e-3,
the final valid mask and the keyframes' masks exactly.
"""
import numpy as np
import torch

from .test_torch_undistort import INTR
from .torch_parity import jax_state_tree, np_

torch.set_num_threads(1)

W, H = INTR["width"], INTR["height"]

SCENE = dict(n_frames=3, width=W, height=H, n_gaussians=1500, seed=3,
             revolutions=0.2)
CFG_KW = dict(tile_h=16, tile_w=128, max_span_x=2, max_span_y=4, chunk=64,
              tile_batch=4, max_pairs=1 << 13)
MP_KW = dict(min_num_initial_map_kfs=2, depth_cache=2,
             do_gaus_pyramid_training=False)
ITERS_PER_FRAME = 2


def _drive(mapper, frontend, frames):
    losses = []
    mapper.loss_sync_interval = 1
    for f in frames:
        frontend.track(f)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(ITERS_PER_FRAME):
                losses.append(mapper.train_iteration())
    return losses


def test_mapper_run_on_distorted_frames_matches(tmp_path):
    """Frames of the port's synthetic room rendered with K's focal length,
    fed as the raw frames of a camera with DIST: both mappers undistort
    each keyframe and gate the loss with the valid mask."""
    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    from legslam_tpu.config import MapperParams as JaxMP
    from legslam_tpu.config import RasterizeConfig as JaxCfg
    from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
    from legslam_tpu.slam.trajectory import TrajectoryFrontend as JaxFrontend
    ds = SyntheticDataset(**SCENE, device="cpu")
    ds.intrinsics = {k: INTR[k] for k in ("width", "height", "fx", "fy",
                                          "cx", "cy")}
    frames = [ds.read(i) for i in range(len(ds))]
    kw = dict(capacity=1 << 10, max_per_tile=512, include_lang_feat=False,
              binning_refresh_interval=1, seed=0)
    fj = JaxFrontend(INTR, kf_stride=1, max_corners=200)
    mj = JaxMapper(fj.queue, INTR, mp=JaxMP(**MP_KW),
                   cfg=JaxCfg(**CFG_KW, backend="pallas",
                              pallas_interpret=True, pallas_sort=True),
                   result_dir=str(tmp_path / "jax"), **kw)
    ft = TrajectoryFrontend(INTR, kf_stride=1, max_corners=200)
    mt = GaussianMapper(ft.queue, INTR, mp=MapperParams(**MP_KW),
                        cfg=RasterizeConfig(**CFG_KW, backend="cuda",
                                            cuda_sort=True),
                        result_dir=str(tmp_path / "torch"), device="cpu",
                        **kw)
    assert mt.undistortion is not None and mj.undistortion is not None
    lj, lt = _drive(mj, fj, frames), _drive(mt, ft, frames)
    assert len(lt) == len(lj) == 4 and None not in lt
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    np.testing.assert_array_equal(G.state_to_numpy(mt.state)["valid"],
                                  jax_state_tree(mj.state)["valid"])
    for fid, kf in mt.keyframes.items():
        np.testing.assert_array_equal(np_(kf.mask[-1]),
                                      np.asarray(mj.keyframes[fid].mask[-1]))
