"""The stereo mode of legslam_torch's TrajectoryFrontend, the mapper's
stereo branch fed from its packets, and the app on a EuRoC layout with the
default frontend, held to the benchmark's plain SGM reference
(legs_bench/reference/stereo.py, which imports neither the port nor JAX).

* the port's SGM (ops/stereo.py) against the reference on seeded 64x128
  pairs with 32 disparities: the aggregated cost and the integer
  disparities exact, the parabola's offset within 1e-6;
* the stereo frontend's map points and exported keypoints against the
  reference's back-projection of the same disparity, and no SGM on a
  frame that is no keyframe;
* the mapper's stereo growth from the packet's disparity, one SGM a
  keyframe in all;
* RGB-D packets and operations bit for bit those of JAX's frontend;
* `replica_rgbd --sensor stereo|auto` on a EuRoC layout with the default
  frontend: one SGM a keyframe, the mapper's branch reading each.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from legslam_torch.ops import stereo as S

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from legs_bench.reference import stereo as R  # noqa: E402

torch.set_num_threads(1)

W, H = 128, 72
FX = 64.0
# at fx 64 a 0.5 m baseline puts the room (1-4 m) at 8-32 px
BASELINE = 0.5
NUM_DISP, MIN_DISP = 32, 2


@pytest.fixture(scope="module", params=[3, 11])
def pair(request):
    """A seeded grey pair, 64x128: smoothed noise, the right view the left
    shifted by a disparity that steps between three planes."""
    rng = np.random.default_rng(request.param)
    h, w = 64, 128
    tex = rng.uniform(size=(h, w + 40)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 0)) / 3.0
    left = tex[:, 20:20 + w]
    disp = np.where(np.arange(w) < 40, 6, np.where(np.arange(w) < 90, 14,
                                                   22))
    cols = np.clip(np.arange(w) + 20 - disp, 0, w + 39)
    right = tex[:, cols]
    noise = rng.normal(scale=0.01, size=right.shape).astype(np.float32)
    return torch.as_tensor(left), torch.as_tensor(right + noise)


def test_sgm_matches_the_reference(pair):
    left, right = pair
    agg = S.sgm_aggregate(left, right, NUM_DISP)
    want = R.aggregate(left, right, NUM_DISP)
    assert torch.equal(agg, want)
    got = S.sgm_disparity(left, right, num_disp=NUM_DISP,
                          min_disp=MIN_DISP).numpy()
    ref = R.winner(want, NUM_DISP, MIN_DISP).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    ok = ref > 0
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(np.floor(got[ok] + 0.5),
                                  np.floor(ref[ok] + 0.5))
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-6)
    # the reference sees a dropped path
    three = R.aggregate(left, right, NUM_DISP, paths=R.PATHS[:3])
    assert not torch.equal(agg, three)


def _stereo_frames(n: int):
    """n frames of the benchmark's room as a rectified grey pair."""
    from legs_bench.drivers.stereo_stream import Feed, make_stereo_sequence
    intr = dict(width=W, height=H, fx=FX, fy=FX, cx=(W - 1) / 2,
                cy=(H - 1) / 2)
    seq = make_stereo_sequence(5, 40, intr, BASELINE, torch.device("cpu"),
                               20.0)
    feed = Feed(seq)
    return intr, seq, [feed.next() for _ in range(n)]


def _frontend(intr, kf_stride=2):
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    return TrajectoryFrontend(intr, kf_stride=kf_stride, sensor="stereo",
                              stereo_baseline=BASELINE,
                              min_disparity=MIN_DISP,
                              num_disparity=NUM_DISP, device="cpu")


class _CountSgm:
    def __init__(self, monkeypatch):
        self.real, self.calls = S.sgm_disparity, 0
        monkeypatch.setattr(S, "sgm_disparity", self)

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.real(*a, **kw)


def test_stereo_frontend_points_match_the_reference(monkeypatch):
    intr, seq, frames = _stereo_frames(2)
    fe = _frontend(intr)
    sgm = _CountSgm(monkeypatch)
    packet = fe.track(frames[0])
    assert fe.track(frames[1]) is None
    assert sgm.calls == 1
    op = fe.queue.pop_operation()
    left, right = (torch.as_tensor(frames[0].color),
                   torch.as_tensor(frames[0].color_right))
    want_disp = R.disparity(left, right, NUM_DISP, MIN_DISP).numpy()
    np.testing.assert_array_equal(packet.disparity.numpy() > 0,
                                  want_disp > 0)
    np.testing.assert_allclose(packet.disparity.numpy(), want_disp,
                               rtol=0, atol=1e-6)
    assert packet.color_right is frames[0].color_right
    assert packet.depth is None
    kp = packet.kp_pixels
    d = R.keypoint_disparity(kp, packet.disparity.numpy())
    want = R.keypoint_points(kp, d, frames[0].color, frames[0].c2w, intr,
                             BASELINE)
    z = packet.kp_points_local[:, 2]
    is_map = z > 0
    assert is_map.sum() == len(want["map"][0]) > 10
    # every promoted keypoint with a depth, and only those, is a map point
    np.testing.assert_array_equal(is_map[::R.MAP_POINT_STRIDE],
                                  (want["z"][::R.MAP_POINT_STRIDE] > 0))
    np.testing.assert_allclose(z[is_map], want["z"][is_map], rtol=1e-5)
    assert (packet.kp_points_local[~is_map] == -1.0).all()
    np.testing.assert_allclose(op.points_xyz, want["map"][0], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(op.points_color, want["map"][1])
    # the right camera sits +b along x: the room lies in front of both
    assert (want["z"][want["z"] > 0] > 0.5).all()


def test_mapper_reads_the_packet_disparity(monkeypatch):
    from legslam_torch.config import MapperParams
    from legslam_torch.mapper.mapper import GaussianMapper
    intr, seq, frames = _stereo_frames(6)
    intr = dict(intr, stereo_baseline=BASELINE)
    fe = _frontend(intr)
    mp = MapperParams(stereo_min_disparity=MIN_DISP,
                      stereo_num_disparity=NUM_DISP, depth_cache=100,
                      min_num_initial_map_kfs=100)
    m = GaussianMapper(fe.queue, intr, mp=mp, capacity=1 << 12,
                       sensor_type="stereo", device="cpu")
    sgm = _CountSgm(monkeypatch)
    packets = [p for p in (fe.track(f) for f in frames) if p is not None]
    m.drain_operations()
    assert len(packets) == 3 and sgm.calls == 3
    assert len(m._depth_cache) == 3
    for p, (world, cols, _) in zip(packets, m._depth_cache):
        d = R.keypoint_disparity(p.kp_pixels, p.disparity.numpy())
        want = R.keypoint_points(p.kp_pixels, d, p.color,
                                 frames[p.fid].c2w, intr, BASELINE)
        # every keypoint with a valid disparity, map point or not
        assert len(world) == len(want["inactive"][0]) == (d > 0).sum()
        np.testing.assert_allclose(world, want["inactive"][0], rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(cols, want["inactive"][1])
    # a packet without a disparity: the mapper matches its pair itself
    import dataclasses
    m2 = GaussianMapper(fe.queue, intr, mp=mp, capacity=1 << 12,
                        sensor_type="stereo", device="cpu")
    m2._ingest_keyframe(dataclasses.replace(packets[0], disparity=None))
    assert sgm.calls == 4
    np.testing.assert_array_equal(m2._depth_cache[0][0],
                                  m._depth_cache[0][0])


def test_rgbd_packets_are_jax_frontends(monkeypatch):
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    from legslam_tpu.slam.trajectory import TrajectoryFrontend as JaxFront
    ds = SyntheticDataset(n_frames=4, width=160, height=96,
                          n_gaussians=1500, seed=7, clutter_ratio=0.0,
                          revolutions=0.1, device="cpu")
    sgm = _CountSgm(monkeypatch)
    a = TrajectoryFrontend(ds.intrinsics, kf_stride=2)
    b = JaxFront(ds.intrinsics, kf_stride=2)
    for f in ds:
        pa, pb = a.track(f), b.track(f)
        assert (pa is None) == (pb is None)
        if pa is None:
            continue
        assert pa.color_right is None and pa.disparity is None
        for k in ("R", "t", "kp_pixels", "kp_points_local"):
            np.testing.assert_array_equal(getattr(pa, k), getattr(pb, k))
        oa, ob = a.queue.pop_operation(), b.queue.pop_operation()
        np.testing.assert_array_equal(oa.points_xyz, ob.points_xyz)
        np.testing.assert_array_equal(oa.points_color, ob.points_color)
    assert sgm.calls == 0


@pytest.mark.parametrize("sensor", ["stereo", "auto"])
def test_app_stereo_on_the_default_frontend(tmp_path, monkeypatch, capsys,
                                            sensor):
    from legslam_torch.apps.replica_rgbd import main
    from tests.test_torch_app import FAST_ARGS, MAPPER_YAML
    from tests.util import make_euroc_dir
    n = 6
    intr, seq, frames = _stereo_frames(n)
    scene = make_euroc_dir(
        tmp_path, n=n, width=W, height=H, baseline=BASELINE,
        frames=[(f.color, f.color_right, f.c2w) for f in frames],
        intrinsics=(FX, FX, intr["cx"], intr["cy"]),
        distortion=(0.0, 0.0, 0.0, 0.0))
    cfg = tmp_path / "tiny_stereo.yaml"
    cfg.write_text(MAPPER_YAML.replace("min_num_initial_map_kfs: 4",
                                       "min_num_initial_map_kfs: 2") +
                   f"Stereo.min_disparity: {MIN_DISP}\n"
                   f"Stereo.num_disparity: {NUM_DISP}\n")
    sgm = _CountSgm(monkeypatch)
    handed = []
    real = S.stereo_inactive_geo_densify

    def densify(*a, **kw):
        handed.append(kw.get("disparity"))
        return real(*a, **kw)
    monkeypatch.setattr(S, "stereo_inactive_geo_densify", densify)
    out = str(tmp_path / "run")
    prof = tmp_path / "prof"
    main(["--data", scene, "--out", out, "--cfg", str(cfg), "--sensor",
          sensor, "--profile-dir", str(prof)] + FAST_ARGS)
    text = capsys.readouterr().out
    assert "Keyframes: 3" in text, text
    assert sgm.calls == 3
    assert len(handed) == 3 and all(d is not None for d in handed)
    import json
    trace = json.loads((prof / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "legslam_span"]
    names = {e["name"] for e in spans}
    assert {"track.stereo", "stereo.sgm", "sgm.census", "sgm.cost",
            "sgm.aggregate", "sgm.disparity", "ingest.stereo"} <= names
    sgm_spans = [e for e in spans if e["name"] == "stereo.sgm"]
    assert len(sgm_spans) == 3
    assert {e["args"]["keyframe"] for e in sgm_spans} == {0, 2, 4}
    assert sgm_spans[0]["args"]["steps"] == W - 1
    # the tracer is off again: a span is the shared no-op
    from legslam_torch.utils import runtime
    assert runtime.span("stereo.sgm") is runtime.span("sgm.cost")
    from legslam_torch.utils import ply
    data = ply.load_gaussian_ply(str(Path(out) / "experiment" / "ply" /
                                     "point_cloud" / "point_cloud.ply"))
    assert data["xyz"].shape[0] > 100


def test_reference_imports_neither_the_port_nor_jax():
    import subprocess
    import textwrap
    code = textwrap.dedent('''
        import sys
        import legs_bench.reference.stereo, legs_bench.sgm_bound
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
        ''')
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "legslam_tpu",
                       "legslam_torch"}
