"""The visual tracking slice on the card against the same code on the CPU,
without JAX, so this file also runs on a machine with a card (the JAX
conftest skipped):

    python -m pytest --noconftest tests/test_torch_tracking_cuda.py -q

Marker `cuda`: skipped without a card.
* SGM (ops/stereo.py) on a seeded textured pair at 160x96 with 64
  disparities: the aggregated costs (integer-valued) equal, the integer
  disparities equal, the subpixel term within 1e-5;
* the stereo tracker with its SGM on the card gives the CPU tracker's
  operation stream (its depth is computed from the same integer costs);
* the native RGB-D tracker driving a GaussianMapper on "cuda" (the
  compositing and sort kernels): it initializes, trains and applies the
  tracker's local-BA operations, and its keyframe poses are the
  tracker's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from legslam_torch.ops import stereo as S

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(h=96, w=160, disparity=20, seed=0):
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.uniform(size=(1, 1, h // 8 + 2, w // 8 + 2)),
                           dtype=torch.float32)
    left = torch.nn.functional.interpolate(
        base, size=(h + 16, w + 16), mode="bilinear",
        align_corners=False)[0, 0, 8:8 + h, 8:8 + w]
    left = (left - left.min()) / (left.max() - left.min())
    return left, torch.roll(left, -disparity, dims=1)


@pytest.mark.cuda
def test_sgm_card_matches_cpu():
    dev = _card()
    left, right = _pair()
    agg_cpu = S.sgm_aggregate(left, right, 64)
    agg_card = S.sgm_aggregate(left.to(dev), right.to(dev), 64)
    assert torch.equal(agg_card.cpu(), agg_cpu)
    assert torch.equal(agg_card.argmin(-1).cpu(), agg_cpu.argmin(-1))
    d_cpu = S.sgm_disparity(left, right, 64)
    d_card = S.sgm_disparity(left.to(dev), right.to(dev), 64).cpu()
    assert torch.equal(d_card > 0, d_cpu > 0)
    np.testing.assert_allclose(d_card.numpy(), d_cpu.numpy(), atol=1e-5,
                               rtol=0)
    assert abs(float(d_cpu[d_cpu > 0].median()) - 20) < 1.0


def _scene(n, **kw):
    from legslam_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(n_frames=n, width=160, height=96,
                          n_gaussians=2500, seed=11, clutter_ratio=0.0,
                          revolutions=0.1, device="cpu", **kw)
    return ds.intrinsics, [ds.read(i) for i in range(n)]


def _right_view(color, depth, fx, baseline):
    h, w, _ = color.shape
    us = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    src = np.clip(us + fx * baseline / np.where(depth > 1e-3, depth, 1e6),
                  0, w - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, w - 1)
    f = (src - lo)[..., None]
    rows = np.arange(h)[:, None]
    return (color[rows, lo] * (1 - f) + color[rows, hi] * f).astype(
        np.float32)


@pytest.mark.cuda
def test_stereo_tracker_on_card_matches_cpu(monkeypatch):
    from legslam_torch.slam.tracking import TrackingFrontend
    dev = _card()
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    intr, frames = _scene(6)
    rights = [_right_view(f.color, f.depth, intr["fx"], 1.0) for f in frames]
    runs = []
    for d in ("cpu", dev):
        fe = TrackingFrontend(intr, sensor="stereo", stereo_baseline=1.0,
                              max_corners=300, kf_trans_th=0.05,
                              kf_rot_deg_th=5.0, device=d)
        for f, r in zip(frames, rights):
            fe.track(dataclasses.replace(f, depth=None, c2w=None),
                     color_right=r)
        runs.append(fe)
    (ac, bc), (ag, bg) = runs[0].trajectory(), runs[1].trajectory()
    np.testing.assert_array_equal(ag, ac)
    np.testing.assert_array_equal(bg, bc)
    assert runs[1].n_keyframes_created == runs[0].n_keyframes_created >= 2


@pytest.mark.cuda
def test_native_tracker_drives_mapper_on_card(monkeypatch, tmp_path):
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.config import (MapperParams, OptimizationParams,
                                      RasterizeConfig)
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import sort as cs
    from legslam_torch.slam.tracking import TrackingFrontend, _use_native
    dev = _card()
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    assert _use_native()
    intr, frames = _scene(10)
    fe = TrackingFrontend(intr, ransac_thresh=0.1, device=dev)
    mapper = GaussianMapper(
        fe.queue, intr, opt=OptimizationParams(densify_from_iter=10,
                                               densification_interval=40),
        mp=MapperParams(min_num_initial_map_kfs=2),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16"),
        capacity=1 << 14, result_dir=str(tmp_path), device=dev)
    kernels = (cf.composite_forward, cb.composite_backward, cs.sort_keys,
               cs.sort_kv)
    for k in kernels:
        k.launches = 0
    applied = []
    handle = mapper.handle_operation

    def counted(op):
        applied.append(op.kind.name)
        handle(op)
    mapper.handle_operation = counted
    for f in frames:
        process_frame(dataclasses.replace(f, c2w=None), fe, mapper,
                      iters_per_frame=2)
    assert fe.lost_frames == 0 and "LOCAL_BA" in applied
    assert mapper.state is not None and mapper.iteration > 0
    assert all(k.launches > 0 for k in kernels)
    for fid, kf in mapper.keyframes.items():
        np.testing.assert_array_equal(kf.R, fe.keyframes[fid].R)
    assert torch.isfinite(mapper.state.params.xyz).all()
