"""legslam_torch's visual tracking frontend (slam/tracking.py) against
legslam_tpu's, RGB-D mode, on the CPU.

Both packages take the native route (LEGSLAM_NATIVE_TRACKING=1, set with
monkeypatch for both). Their C++ cores are built from the same source
with the same flags in this process: the port's by its own loader, the
JAX package's privately by tests/torch_native_pin.py, which checks the
flags (the shared native/libtracking_core.so can be left an -O3 build by
concurrent test processes, whose KLT tracks differ in the last bits). So
corners and tracks agree bit for bit, and the RANSACs draw from numpy
Generators seeded alike. The frames are rendered once with the port's
SyntheticDataset and wrapped in each package's RGBDFrame, so both
trackers see the same arrays. The operation streams must agree: R and t
within 1e-6 (expected identical), everything else exactly (kinds, fids,
scales, points, kp_pixels, kp_points_local, the live keyframes, lost
frames and trajectory()).

The helpers here are shared with tests/test_torch_tracking_modes.py and
tests/test_torch_mapper_ops.py, which holds the loop-closure case (its
scene is rendered once there, for the tracker and the mapper replay).
"""
import dataclasses

import numpy as np
import pytest
import torch

from legslam_torch.data.synthetic import SyntheticDataset
from tests.torch_native_pin import jax_native_pin

torch.set_num_threads(1)

# pytest finds fixtures by name in the module that uses them
jax_native_pin = jax_native_pin

# the scene of tests/test_tracking.py (gentle_seq)
GENTLE = dict(n_frames=20, width=256, height=144, n_gaussians=7000,
              revolutions=0.15, clutter_ratio=0.0)


def render(**scene):
    """(intrinsics, frames) of the port's SyntheticDataset on the CPU."""
    ds = SyntheticDataset(**scene, device="cpu")
    return ds.intrinsics, [ds.read(i) for i in range(len(ds))]


def as_frame(module, fr, **changes):
    """`fr` as module's RGBDFrame (the same arrays), with changes."""
    out = module.RGBDFrame(index=fr.index, timestamp=fr.timestamp,
                           color=fr.color, depth=fr.depth, c2w=fr.c2w,
                           color_right=fr.color_right)
    return dataclasses.replace(out, **changes)


@pytest.fixture
def native_route(monkeypatch, jax_native_pin):
    """Both trackers' modules on the native route, the JAX one on the
    private build of tests/torch_native_pin.py."""
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    from legslam_tpu.slam import tracking as JT
    from legslam_torch.slam import tracking as TT
    assert JT._use_native() and TT._use_native()
    return JT, TT


def run_both(native_route, intr, frames, changes=None, track_kw=None,
             marks=None, **kw):
    """Both packages' TrackingFrontend(intr, **kw) over `frames` (GT
    hidden; `changes(i, frame)` gives more frame changes, `track_kw(i)`
    the track() keywords). Returns (jax frontend, its ops, port frontend,
    its ops); the ops are popped after every frame. `marks`, a list, gets
    the port's (ops so far, live keyframes) after each frame."""
    from legslam_tpu.data import datasets as JD
    from legslam_torch.data import datasets as TD
    JT, TT = native_route
    out = []
    for mod, data, extra in ((JT, JD, {}), (TT, TD, {"device": "cpu"})):
        fe = mod.TrackingFrontend(intr, **kw, **extra)
        ops = []
        for i, fr in enumerate(frames):
            ch = dict(c2w=None, **(changes(i, fr) if changes else {}))
            fe.track(as_frame(data, fr, **ch),
                     **(track_kw(i) if track_kw else {}))
            ops.extend(iter(fe.queue.pop_operation, None))
            if marks is not None and mod is TT:
                marks.append((len(ops), set(fe.queue.live_keyframe_ids())))
        out += [fe, ops]
    return tuple(out)


def _same_array(a, b, what, atol=0.0):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if atol:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_streams_equal(jops, tops):
    """Operation streams equal: R, t within 1e-6, the rest exactly."""
    assert [o.kind.name for o in tops] == [o.kind.name for o in jops]
    for k, (oj, ot) in enumerate(zip(jops, tops)):
        where = f"op {k} ({oj.kind.name})"
        assert ot.scale == oj.scale, where
        _same_array(oj.points_xyz, ot.points_xyz, where + " points_xyz")
        _same_array(oj.points_color, ot.points_color, where + " colors")
        assert [p.fid for p in ot.keyframes] == \
            [p.fid for p in oj.keyframes], where
        for pj, pt in zip(oj.keyframes, ot.keyframes):
            w = f"{where} fid {pj.fid}"
            _same_array(pj.R, pt.R, w + " R", atol=1e-6)
            _same_array(pj.t, pt.t, w + " t", atol=1e-6)
            _same_array(pj.kp_pixels, pt.kp_pixels, w + " kp_pixels")
            _same_array(pj.kp_points_local, pt.kp_points_local,
                        w + " kp_points_local")
            assert (pt.timestamp, pt.is_loop_kf, pt.scale) == \
                (pj.timestamp, pj.is_loop_kf, pj.scale), w
            assert pt.color is pj.color or \
                np.array_equal(pt.color, pj.color), w


def assert_frontends_equal(fj, ft):
    assert ft.queue.live_keyframe_ids() == fj.queue.live_keyframe_ids()
    for name in ("lost_frames", "n_keyframes_created", "n_loop_closures",
                 "n_relocalizations", "n_map_resets", "n_scale_refinements",
                 "initialized", "mono_scale", "n_imu_inits", "imu_ready"):
        assert getattr(ft, name) == getattr(fj, name), name
    (aj, bj), (at, bt) = fj.trajectory(), ft.trajectory()
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(bt, bj)


@pytest.fixture(scope="module")
def gentle():
    return render(**GENTLE)


def test_rgbd_stream_matches(native_route, gentle):
    intr, frames = gentle
    fj, jops, ft, tops = run_both(native_route, intr, frames,
                                  ransac_thresh=0.1)
    assert len(jops) >= 3 and ft.lost_frames == 0
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)
    np.testing.assert_array_equal(ft.last_vis["pts"], fj.last_vis["pts"])


def test_culling_stream_matches(native_route, gentle):
    """A keyframe every frame with long-lived tracks: redundancy culling
    shrinks the live set the same on both sides
    (tests/test_tracking.py:144)."""
    intr, frames = gentle
    fj, jops, ft, tops = run_both(
        native_route, intr, frames, ransac_thresh=0.1, kf_trans_th=0.001,
        kf_rot_deg_th=0.1, enable_loop_closing=False)
    assert ft.num_keyframes < len(frames)
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_relocalization_after_blackout_matches(native_route, gentle):
    """Blacked-out frames lose tracking and the frontend relocalizes when
    they return (tests/test_tracking_mono.py:137), on both sides alike."""
    intr, frames = gentle
    black = dataclasses.replace(frames[0],
                                color=np.zeros_like(frames[0].color))
    seq = frames[:10] + [dataclasses.replace(black, index=100 + i)
                         for i in range(4)] + frames[8:]
    fj, jops, ft, tops = run_both(native_route, intr, seq,
                                  ransac_thresh=0.1, reloc_after=2)
    assert ft.lost_frames > 0 and ft.n_relocalizations >= 1
    assert_streams_equal(jops, tops)
    assert_frontends_equal(fj, ft)


def test_packet_carries_the_callers_lf_image(gentle):
    """A keyframe packet holds the caller's lf_image object itself (the
    encoder's tensor stays on its device), not a copy."""
    from legslam_torch.slam.tracking import TrackingFrontend
    intr, frames = gentle
    fe = TrackingFrontend(intr, ransac_thresh=0.1, device="cpu")
    lfs = [torch.randn(37, 37, 64) for _ in frames[:6]]
    packets = {}
    for fr, lf in zip(frames[:6], lfs):
        p = fe.track(dataclasses.replace(fr, c2w=None), lf_image=lf)
        if p is not None:
            packets[fr.index] = p
    assert packets
    for fid, p in packets.items():
        assert p.lf_image is lfs[fid]


def test_rigid_primitives_match(native_route):
    """rigid_align, ransac_rigid (same Generator draws), _fractional_rigid,
    essential / homography RANSAC with their decompositions, the
    triangulations and pnp_gn on the inputs of tests/test_tracking.py and
    tests/test_tracking_mono.py: identical outputs."""
    JT, TT = native_route
    rng = np.random.default_rng(0)
    A = rng.normal(size=(80, 3)).astype(np.float32)
    ang, axis = 0.4, np.array([0.3, -0.5, 0.8])
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = (np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K) \
        .astype(np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    B = A @ R.T + t
    B[::4] += rng.normal(scale=2.0, size=(20, 3)).astype(np.float32)

    def both(name, *args, seeded=False):
        outs = []
        for mod in (JT, TT):
            a = list(args)
            if seeded:
                a.insert(2, np.random.default_rng(7))
            outs.append(getattr(mod, name)(*a))
        return outs

    def eq(a, b):
        if isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                eq(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    eq(*both("rigid_align", A[1::4], B[1::4]))
    eq(*both("ransac_rigid", A, B, seeded=True))
    W = np.eye(4, dtype=np.float32)
    W[:3, :3], W[:3, 3] = R, t
    eq(*both("_fractional_rigid", W, 0.37))
    # two-view geometry on normalized coordinates
    world = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    world[:, 2] += 4.0
    x1 = world[:, :2] / world[:, 2:3]
    cam2 = world @ R.T + t
    x2 = cam2[:, :2] / cam2[:, 2:3]
    ej, et = both("essential_ransac", x1, x2, seeded=True)
    eq(ej, et)
    inl = ej[1]
    eq(*both("decompose_essential", ej[0], x1[inl], x2[inl]))
    planar = world.copy()
    planar[:, 2] = 4.0
    p1 = planar[:, :2] / planar[:, 2:3]
    c2 = planar @ R.T + t
    p2 = c2[:, :2] / c2[:, 2:3]
    hj, ht = both("homography_ransac", p1, p2, seeded=True)
    eq(hj, ht)
    assert hj[0] is not None
    eq(*both("_homography_candidates", hj[0]))
    eq(*both("triangulate_two", R, t, x1[:20], x2[:20]))
    Rs = np.stack([np.eye(3, dtype=np.float32), R])
    ts = np.stack([np.zeros(3, np.float32), t])
    eq(*both("triangulate_multi", Rs, ts, np.stack([x1[0], x2[0]])))
    eq(*both("pnp_gn", world, x2, np.eye(3, dtype=np.float32),
             np.zeros(3, np.float32)))


@pytest.fixture(scope="module")
def aliased_rooms():
    """Room A and its aliased clone B of tests/test_place_recognition.py
    (the first two frames of A, the first of B)."""
    from tests.test_place_recognition import _voxel_shuffle_colors
    scene = dict(n_frames=40, width=320, height=192, n_gaussians=9000,
                 revolutions=0.5, radius=1.0, clutter_ratio=0.0, seed=0)
    ds_a = SyntheticDataset(**scene, device="cpu")
    ds_b = SyntheticDataset(**scene, device="cpu")
    ds_b._colors = _voxel_shuffle_colors(ds_b._xyz, ds_b._colors)
    return ds_a.intrinsics, ds_a.read(0), ds_a.read(1), ds_b.read(0)


def test_place_recognition_helpers_match(native_route, aliased_rooms):
    """_pool_gray, _thumb, _peak_corr, _patch_descriptors and _place_score
    on the aliased-room views (tests/test_place_recognition.py:60):
    identical, and the true revisit still outscores the clone."""
    JT, TT = native_route
    _, fa0, fa1, fb0 = aliased_rooms
    scores = {}
    for mod in (JT, TT):
        g = [mod.to_gray(f.color) for f in (fa0, fa1, fb0)]
        d = [mod._patch_descriptors(x, mod.detect_corners(x, 300))
             for x in g]
        scores[mod] = dict(
            pooled=[mod._pool_gray(x) for x in g],
            thumb=[mod._thumb(x) for x in g],
            desc=d,
            true=mod._place_score(d[1][0], d[1][1], d[0][0], d[0][1]),
            alias=mod._place_score(d[2][0], d[2][1], d[0][0], d[0][1]),
            pc=mod._peak_corr(mod._pool_gray(g[1]), mod._pool_gray(g[0])))
    sj, st = scores[JT], scores[TT]
    for k in ("pooled", "thumb"):
        for a, b in zip(sj[k], st[k]):
            np.testing.assert_array_equal(b, a)
    for (dj, pj), (dt, pt) in zip(sj["desc"], st["desc"]):
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(pt, pj)
    assert (st["true"], st["alias"], st["pc"]) == \
        (sj["true"], sj["alias"], sj["pc"])
    assert st["true"] > 1.8 * st["alias"]


def test_rotated_revisit_scores_match(native_route, aliased_rooms):
    """The rotated-revisit recall bound (tests/test_place_recognition.py:
    160): both packages score a revisit rotated in-plane by 0-30 degrees
    alike, and the port keeps the bound: <= 5 degrees passes the loop
    gates, >= 15 degrees fails both."""
    import cv2
    JT, TT = native_route
    intr, fa0, fa1, _ = aliased_rooms
    w, h = intr["width"], intr["height"]
    scores = {}
    for mod in (JT, TT):
        g0, g1 = mod.to_gray(fa0.color), mod.to_gray(fa1.color)
        d0, p0 = mod._patch_descriptors(g0, mod.detect_corners(g0, 300))
        out = []
        for deg in (0.0, 5.0, 15.0, 30.0):
            M = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
            gr = cv2.warpAffine(g1, M, (w, h), flags=cv2.INTER_LINEAR)
            dr, pr = mod._patch_descriptors(gr, mod.detect_corners(gr, 300))
            out.append((mod._place_score(dr, pr, d0, p0),
                        mod._peak_corr(mod._pool_gray(gr),
                                       mod._pool_gray(g0))))
        scores[mod] = out
    assert scores[TT] == scores[JT]
    fe = TT.TrackingFrontend(intr, device="cpu")
    th, app_th = fe.loop_desc_th, fe.loop_appearance_th
    (s0, pc0), (s5, _), *rotated = scores[TT]
    assert s0 > th and pc0 > app_th and s5 > th
    assert all(s < th and pc < app_th for s, pc in rotated)


def test_frontend_defaults_match_jax(native_route):
    """Every constructor default of the port's TrackingFrontend is JAX's
    (the port adds only `device`), so the temporal-consistency gate of
    tests/test_place_recognition.py:205 (loop_consistency 2, nothing
    pending) holds on both."""
    import inspect
    JT, TT = native_route
    pj = inspect.signature(JT.TrackingFrontend).parameters
    pt = inspect.signature(TT.TrackingFrontend).parameters
    assert list(pt) == list(pj) + ["device"]
    assert all(pt[k].default == pj[k].default for k in pj)
    assert pt["device"].default == "cuda"
    fe = TT.TrackingFrontend(dict(width=64, height=48, fx=50.0, fy=50.0,
                                  cx=31.5, cy=23.5), device="cpu")
    assert fe.loop_consistency == 2 and fe._loop_pending is None


def test_relocalization_among_lookalikes_matches(native_route,
                                                 aliased_rooms):
    """The keyframe store holds the true place and its clone 40 m away;
    both packages relocalize onto the true place, to the same pose
    (tests/test_place_recognition.py:142)."""
    from legslam_tpu.data import datasets as JD
    from legslam_torch.data import datasets as TD
    JT, TT = native_route
    intr, fa0, fa1, fb0 = aliased_rooms
    poses = []
    for mod, data, extra in ((JT, JD, {}), (TT, TD, {"device": "cpu"})):
        fe = mod.TrackingFrontend(intr, ransac_thresh=0.1, **extra)
        for fid, fr, shift in ((0, fa0, 0.0), (1, fb0, 40.0)):
            gray = mod.to_gray(fr.color)
            w2c = np.linalg.inv(fr.c2w)
            R = np.ascontiguousarray(w2c[:3, :3]).astype(np.float32)
            t = w2c[:3, 3].astype(np.float32) - \
                R @ np.array([shift, 0.0, 0.0], np.float32)
            fe.keyframes[fid] = mod._KF(fid=fid, R=R, t=t, gray=gray,
                                        color=fr.color, depth=fr.depth)
            fe._kf_order.append(fid)
            fe._register_kf_appearance(fid, gray)
        q = as_frame(data, fa1)
        assert fe._relocalize(q, mod.to_gray(q.color))
        poses.append((fe._cur_R, fe._cur_t))
    np.testing.assert_allclose(poses[1][0], poses[0][0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(poses[1][1], poses[0][1], atol=1e-6, rtol=0)
    w2c = np.linalg.inv(fa1.c2w)
    assert np.linalg.norm(poses[1][1] - w2c[:3, 3]) < 0.5


def test_native_route_raises_instead_of_falling_back(monkeypatch, gentle,
                                                    tmp_path):
    """When the native route is chosen and its library cannot be built
    (here: no g++ on the PATH), tracking raises: it never drops to
    another detector or tracker."""
    from legslam_torch.slam import native
    from legslam_torch.slam import tracking as TT
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    intr, frames = gentle
    gray = TT.to_gray(frames[0].color)
    with pytest.raises(RuntimeError, match="native tracking kernels"):
        TT.detect_corners(gray, 100)


@pytest.mark.parametrize("shape", [(48, 64, 3), (48, 64)])
def test_to_gray_matches_jax_on_float_frames(shape):
    """Float frames (out of [0, 1] too, where the clip acts) give JAX's
    uint8 gray bit for bit, in float32 and float64."""
    from legslam_torch.slam import tracking as TT
    from legslam_tpu.slam import tracking as JT
    rng = np.random.default_rng(len(shape))
    color = rng.uniform(-0.2, 1.2, size=shape)
    for dtype in (np.float32, np.float64):
        c = color.astype(dtype)
        g = TT.to_gray(c)
        assert g.dtype == np.uint8 and g.shape == shape[:2]
        np.testing.assert_array_equal(g, JT.to_gray(c.copy()))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_to_gray_rejects_integer_frames(dtype):
    """An integer frame raises a TypeError naming the float32 [0, 1] frame
    it expects (JAX's in-place division raises a numpy casting error; its
    uint8 sum would wrap first)."""
    from legslam_torch.slam import tracking as TT
    color = np.full((8, 8, 3), 200, dtype)
    with pytest.raises(TypeError, match=r"float32 frame in \[0, 1\]"):
        TT.to_gray(color)
    with pytest.raises(TypeError, match=r"float32 frame in \[0, 1\]"):
        TT.to_gray(color[..., 0])
