"""legslam_torch's native tracking core (csrc/tracking_core.cpp through
slam/native.py, built with g++ into build/legslam_torch/) against the JAX
package's (native/tracking_core.cpp): Shi-Tomasi corners and pyramidal KLT
tracks bit for bit on the scenes of tests/test_native_tracking.py, that
file's behaviour tests run on the port, and the build's FTZ/DAZ hygiene.

The same source with the same flags on the same host gives the same code,
but an -O3 build's KLT tracks differ from the fast build's in the last
bits. The JAX core compared here is therefore a private build of this
process (tests/torch_native_pin.py) whose recorded flags are the port's
library's, never the shared native/libtracking_core.so, which concurrent
test processes can leave an -O3 build."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from legslam_tpu.slam import native as JN
from legslam_torch.slam import native as TN
from tests import torch_native_pin as NP
from tests.torch_native_pin import jax_native_pin

torch.set_num_threads(1)

# pytest finds fixtures by name in the module that uses them
jax_native_pin = jax_native_pin

# the scene of tests/test_native_tracking.py, copied: importing that
# module loads the shared native/libtracking_core.so (its skipif mark)
H, W = 120, 160


def _scene(rng):
    """Textured float image with strong corners."""
    img = rng.uniform(0.2, 0.4, size=(H, W)).astype(np.float32)
    for (y, x) in [(30, 40), (30, 110), (80, 40), (80, 110), (55, 75)]:
        img[y:y + 14, x:x + 14] += 0.5
    return np.clip(img, 0, 1)


# the settings of test_klt_tracks_match_jax_core
KLT_CASES = [((3, -2), 10, 30), ((2, 0), 10, 30), ((3, -2), 7, 12)]


@pytest.mark.parametrize("seed,max_corners,min_distance",
                         [(0, 64, 5), (1, 64, 9), (2, 32, 5), (3, 32, 7)])
def test_corners_match_jax_core(jax_native_pin, seed, max_corners,
                                min_distance):
    assert JN.available()
    img = _scene(np.random.default_rng(seed))
    a = TN.detect_corners(img, max_corners, min_distance=min_distance)
    b = JN.detect_corners(img, max_corners, min_distance=min_distance)
    assert len(a) >= 10
    np.testing.assert_array_equal(a, b)


def _klt_scene(shift):
    img = _scene(np.random.default_rng(2))
    dx, dy = shift
    moved = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    return img, moved, TN.detect_corners(img, 32, min_distance=5)


@pytest.mark.parametrize("shift,win,iters", KLT_CASES)
def test_klt_tracks_match_jax_core(jax_native_pin, shift, win, iters):
    img, moved, pts = _klt_scene(shift)
    a, ok_a = TN.klt_track(img, moved, pts, win=win, iters=iters)
    b, ok_b = JN.klt_track(img, moved, pts, win=win, iters=iters)
    np.testing.assert_array_equal(ok_a, ok_b)
    np.testing.assert_array_equal(a, b)


def test_parity_cases_use_a_private_jax_build(jax_native_pin):
    """The JAX core these cases compare with is this process's private
    build, not the shared native/libtracking_core.so, and it was built
    with the flags of the port's library."""
    lib = JN.load()
    assert Path(lib._name).resolve() != NP.SHARED_LIB.resolve()
    assert NP.recorded_flags(lib) == list(NP.port_flags())


def test_fast_and_plain_builds_track_apart(tmp_path):
    """Why the flags must match: the JAX core built with -O3 and with the
    fast set, each by the JAX module's own build, gives KLT tracks that
    differ on the scene of test_klt_tracks_match_jax_core (by 7.6e-6 to
    1.5e-5 px on an x86-64 host), while both track the same points."""
    libs = {name: NP.build_jax_core(tmp_path / name, flags)
            for name, flags in (("plain", ["-O3"]),
                                ("fast", NP.FAST_FLAGS))}
    if libs["fast"] is None:
        pytest.skip(f"g++ rejects {' '.join(NP.FAST_FLAGS)} on this host")
    assert libs["plain"] is not None
    diff = 0.0
    for shift, win, iters in KLT_CASES:
        img, moved, pts = _klt_scene(shift)
        out = {}
        for name, lib in libs.items():
            with NP.bound(tmp_path / name / NP.JAX_SRC.name, lib):
                out[name] = JN.klt_track(img, moved, pts, win=win,
                                         iters=iters)
        np.testing.assert_array_equal(out["plain"][1], out["fast"][1])
        diff = max(diff, float(np.abs(out["plain"][0] -
                                      out["fast"][0]).max()))
    if diff == 0.0:
        pytest.skip("the -O3 and fast builds track alike on this host")
    assert diff < 1e-3, "the two builds track different points"


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
