"""legslam_torch's tracking frontend in its monocular, inertial and stereo
modes against legslam_tpu's, on the CPU, with the helpers and the native
route of tests/test_torch_tracking.py.

* mono and mono-inertial: the 24-frame 256x144 scene of
  tests/test_tracking_mono.py / test_tracking_imu.py (depth kept for the
  mono scale borrow, as test_mono_scale_refinement_emitted_and_metric
  does; hidden for mono-inertial), and rgbd-inertial through a blackout;
* stereo and stereo-inertial: the 10-frame rectified-pair scene of
  tests/test_tracking_stereo.py, through each package's own SGM (the
  port's on the CPU).
The operation streams agree as in test_torch_tracking.py: R, t within
1e-6, the rest exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_tracking import (assert_frontends_equal,
                                       assert_streams_equal, jax_native_pin,
                                       native_route, render, run_both)

torch.set_num_threads(1)

# pytest finds fixtures by name in the module that uses them
jax_native_pin, native_route = jax_native_pin, native_route

MONO = dict(n_frames=24, width=256, height=144, n_gaussians=7000,
            revolutions=0.15, clutter_ratio=0.0)
STEREO = dict(n_frames=10, width=256, height=144, n_gaussians=7000,
              revolutions=0.15, seed=11, clutter_ratio=0.0)


@pytest.fixture(scope="module")
def mono_seq():
    from legslam_torch.slam import imu as I
    intr, frames = render(**MONO)
    times = np.array([f.timestamp for f in frames])
    c2w = np.stack([f.c2w for f in frames])
    return intr, frames, I.imu_from_poses(times, c2w, rate=100.0)


def test_mono_stream_matches(native_route, mono_seq):
    """Two-view init, PnP tracking, triangulation and the depth-borrow
    SCALE_REFINEMENT."""
    intr, frames, _ = mono_seq
    fj, jops, ft, tops = run_both(native_route, intr, frames,
                                  sensor="mono", scale_refine_kfs=2)
    kinds = [o.kind.name for o in tops]
    assert ft.initialized and ft.num_keyframes >= 3
    assert "SCALE_REFINEMENT" in kinds
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_pure_mono_stream_matches(native_route, mono_seq):
    """No depth anywhere: the packets mark untriangulated tracks z = -1."""
    intr, frames, _ = mono_seq
    fj, jops, ft, tops = run_both(native_route, intr, frames,
                                  changes=lambda i, f: dict(depth=None),
                                  sensor="mono")
    last = tops[-1].keyframes[0]
    assert last.depth is None and (last.kp_points_local[:, 2] == -1).any()
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_mono_inertial_stream_matches(native_route, mono_seq):
    """sensor="mono-inertial" with the IMU rows between frames: the
    visual-inertial alignment initializes and publishes the scale."""
    intr, frames, blocks = mono_seq
    fj, jops, ft, tops = run_both(
        native_route, intr, frames, changes=lambda i, f: dict(depth=None),
        track_kw=lambda i: dict(imu=blocks[i - 1] if i else None),
        sensor="mono-inertial", imu_init_kfs=6, kf_trans_th=0.05,
        kf_rot_deg_th=5.0)
    assert ft.use_imu and ft.imu_ready and ft.n_imu_inits >= 1
    assert "SCALE_REFINEMENT" in [o.kind.name for o in tops]
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_rgbd_inertial_blackout_matches(native_route, mono_seq):
    """sensor="rgbd-inertial": the pose follows the IMU prediction through
    a camera blackout (tests/test_tracking_imu.py:155)."""
    intr, frames, blocks = mono_seq

    def changes(i, f):
        return dict(color=np.zeros_like(f.color)) if 16 <= i < 20 else {}
    fj, jops, ft, tops = run_both(
        native_route, intr, frames[:20], changes=changes,
        track_kw=lambda i: dict(imu=blocks[i - 1] if i else None),
        sensor="rgbd-inertial", imu_init_kfs=6, reloc_after=10 ** 9,
        kf_trans_th=0.05, kf_rot_deg_th=5.0)
    assert ft.imu_ready and ft.lost_frames >= 3
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)
    np.testing.assert_array_equal(ft.poses[19], fj.poses[19])


@pytest.fixture(scope="module")
def stereo_seq():
    from tests.test_tracking_stereo import BASELINE, _right_view
    intr, frames = render(**STEREO)
    rights = [_right_view(f.color, f.depth, intr["fx"]) for f in frames]
    return intr, frames, rights, BASELINE


def test_stereo_stream_matches(native_route, stereo_seq):
    """Depth from each package's census + SGM (the port's on the CPU),
    then the RGB-D machinery; the packets carry the right image."""
    intr, frames, rights, baseline = stereo_seq
    fj, jops, ft, tops = run_both(
        native_route, intr, frames, changes=lambda i, f: dict(depth=None),
        track_kw=lambda i: dict(color_right=rights[i]), sensor="stereo",
        stereo_baseline=baseline, max_corners=300, kf_trans_th=0.05,
        kf_rot_deg_th=5.0)
    assert ft.n_keyframes_created >= 2
    assert any(p.color_right is not None for o in tops for p in o.keyframes)
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_stereo_inertial_stream_matches(native_route, stereo_seq):
    """sensor="stereo-inertial": SGM depth as above, with the IMU rows
    between frames (legslam_torch.slam.imu.imu_from_poses of the GT
    poses): the visual-inertial alignment initializes and the IMU
    prediction seeds the pose solves."""
    from legslam_torch.slam import imu as I
    intr, frames, rights, baseline = stereo_seq
    times = np.array([f.timestamp for f in frames])
    blocks = I.imu_from_poses(times, np.stack([f.c2w for f in frames]),
                              rate=100.0)
    fj, jops, ft, tops = run_both(
        native_route, intr, frames, changes=lambda i, f: dict(depth=None),
        track_kw=lambda i: dict(color_right=rights[i],
                                imu=blocks[i - 1] if i else None),
        sensor="stereo-inertial", stereo_baseline=baseline, max_corners=300,
        imu_init_kfs=3, kf_trans_th=0.05, kf_rot_deg_th=5.0)
    assert ft.sensor == "stereo" and ft.use_imu
    assert ft.imu_ready and ft.n_imu_inits >= 1
    assert ft.n_keyframes_created >= 2
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_stereo_depth_matches(native_route, stereo_seq):
    """The tracker's SGM depth (mean gray, fx * b / disparity) of one
    pair: the same on both sides, bit for bit."""
    JT, TT = native_route
    intr, frames, rights, baseline = stereo_seq
    fj = JT.TrackingFrontend(intr, sensor="stereo", stereo_baseline=baseline)
    ft = TT.TrackingFrontend(intr, sensor="stereo", stereo_baseline=baseline,
                             device="cpu")
    dj = fj._stereo_depth(frames[3].color, rights[3])
    dt = ft._stereo_depth(frames[3].color, rights[3])
    assert np.isfinite(dt).mean() > 0.5
    np.testing.assert_array_equal(dt, dj)


def test_stereo_requires_right_image(stereo_seq):
    from legslam_torch.slam.tracking import TrackingFrontend
    intr, frames, _, baseline = stereo_seq
    fe = TrackingFrontend(intr, sensor="stereo", stereo_baseline=baseline,
                          device="cpu")
    with pytest.raises(ValueError, match="color_right"):
        fe.track(dataclasses.replace(frames[0], depth=None, c2w=None))
