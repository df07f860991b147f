"""legslam_torch's native tracking core (csrc/tracking_core.cpp through
slam/native.py, built with g++ into build/legslam_torch/) against the JAX
package's (native/tracking_core.cpp): Shi-Tomasi corners and pyramidal KLT
tracks bit for bit on the scenes of tests/test_native_tracking.py (the
same source and flags on the same host give the same code), that file's
behaviour tests run on the port, and the build's FTZ/DAZ hygiene."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from legslam_tpu.slam import native as JN
from legslam_torch.slam import native as TN
from tests.test_native_tracking import H, W, _scene

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,max_corners,min_distance",
                         [(0, 64, 5), (1, 64, 9), (2, 32, 5), (3, 32, 7)])
def test_corners_match_jax_core(seed, max_corners, min_distance):
    assert JN.available()
    img = _scene(np.random.default_rng(seed))
    a = TN.detect_corners(img, max_corners, min_distance=min_distance)
    b = JN.detect_corners(img, max_corners, min_distance=min_distance)
    assert len(a) >= 10
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift,win,iters", [((3, -2), 10, 30),
                                             ((2, 0), 10, 30),
                                             ((3, -2), 7, 12)])
def test_klt_tracks_match_jax_core(shift, win, iters):
    img = _scene(np.random.default_rng(2))
    dx, dy = shift
    moved = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    pts = TN.detect_corners(img, 32, min_distance=5)
    a, ok_a = TN.klt_track(img, moved, pts, win=win, iters=iters)
    b, ok_b = JN.klt_track(img, moved, pts, win=win, iters=iters)
    np.testing.assert_array_equal(ok_a, ok_b)
    np.testing.assert_array_equal(a, b)


def test_detect_finds_block_corners():
    img = _scene(np.random.default_rng(0))
    pts = TN.detect_corners(img, 64, min_distance=5)
    assert len(pts) >= 10
    blocks = [(30, 40), (30, 110), (80, 40), (80, 110), (55, 75)]
    for (by, bx) in blocks:
        corners = np.array([[bx, by], [bx + 13, by], [bx, by + 13],
                            [bx + 13, by + 13]], np.float32)
        d = np.linalg.norm(pts[:, None] - corners[None], axis=-1).min()
        assert d < 3.0, (by, bx, d)


def test_min_distance_respected():
    img = _scene(np.random.default_rng(1))
    pts = TN.detect_corners(img, 64, min_distance=9)
    assert len(pts) >= 2
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    d += np.eye(len(pts)) * 1e9
    assert d.min() >= 9.0 - 1e-3


def test_klt_recovers_translation():
    img = _scene(np.random.default_rng(2))
    dx, dy = 3.0, -2.0
    shifted = np.roll(np.roll(img, int(dy), axis=0), int(dx), axis=1)
    pts = TN.detect_corners(img, 32, min_distance=5)
    pts = pts[(pts[:, 0] > 15) & (pts[:, 0] < W - 15) &
              (pts[:, 1] > 15) & (pts[:, 1] < H - 15)]
    nxt, ok = TN.klt_track(img, shifted, pts)
    assert ok.sum() >= 0.8 * len(pts)
    np.testing.assert_allclose(np.median(nxt[ok] - pts[ok], 0), [dx, dy],
                               atol=0.35)


def test_library_is_keyed_by_source_and_flags():
    so = TN.library_path()
    assert so.parent == TN.BUILD_DIR and so.exists()
    assert so == TN._target(TN.FAST_FLAGS) or so == TN._target(TN.BASE_FLAGS)
    assert TN._target(TN.FAST_FLAGS) != TN._target(TN.BASE_FLAGS)


_FTZ_PROBE = """
import numpy as np, torch
def subnormals():
    x = np.array([1e-40], np.float32)
    t = torch.tensor([1e-40], dtype=torch.float32)
    return bool((x * np.float32(0.5))[0] != 0), bool((t * 0.5)[0] != 0)
before = subnormals()
from legslam_torch.slam import native
native.load()
print(before, subnormals())
"""


def test_loading_leaves_ftz_daz_unset():
    """The library is compiled with -ffast-math but linked without it, so
    loading it does not run crtfastmath's constructor: subnormals survive
    in numpy and torch afterwards (checked in a fresh process)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FTZ_PROBE], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.strip()
    assert out == "(True, True) (True, True)", out


def test_frontend_runs_on_native_backend(monkeypatch):
    """The port's TrackingFrontend on the native route
    (tests/test_native_tracking.py:87)."""
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam.tracking import TrackingFrontend, _use_native
    assert _use_native()
    ds = SyntheticDataset(n_frames=6, width=160, height=96,
                          n_gaussians=1200, seed=2, clutter_ratio=0.0,
                          device="cpu")
    fe = TrackingFrontend(ds.intrinsics, max_corners=300, device="cpu")
    for frame in ds:
        f = frame if frame.index == 0 else \
            type(frame)(index=frame.index, timestamp=frame.timestamp,
                        color=frame.color, depth=frame.depth, c2w=None)
        fe.track(f)
    assert fe.num_keyframes >= 1
    est, _ = fe.trajectory()
    assert np.isfinite(est).all()
