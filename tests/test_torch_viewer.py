"""legslam_torch's live viewer (serving/viewer.py) on the CPU, as
tests/test_aux_components.py:136-212 drives the JAX viewer, with the RGB
renders compared to JAX's:

* view-only: a saved PLY attached, /state and /render over HTTP, the
  render_rgb array against the JAX viewer's render of the same orbit pose
  (its XLA reference; the port renders on the "cuda" backend, the
  kernels' plain versions on the CPU) at the forward tolerance of
  tests/test_pallas_composite.py (atol 3e-5, rtol 1e-3);
* a mapper's map: render_rgb equals the mapper's render_from_pose and
  agrees with the JAX mapper's render of the same store;
* the SLAM pane and the map overlay over both packages' trackers: the
  same keypoints, and the same drawn images;
* without cv2 the JPEG routes answer 500 with a message naming cv2, and
  /state and POST /params still answer.
"""
import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.torch_native_pin import jax_native_pin

torch.set_num_threads(1)

# pytest finds fixtures by name in the module that uses them
jax_native_pin = jax_native_pin

FWD_TOL = dict(atol=3e-5, rtol=1e-3)


def _serve(v):
    import threading
    server = v.serve()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _jax_orbit_render(st, q):
    """The JAX viewer's view-only render of query q, as an array."""
    import jax.numpy as jnp

    from legslam_tpu.config import RasterizeConfig
    from legslam_tpu.ops.rasterize import rasterize
    from legslam_tpu.serving.viewer import _orbit_pose
    from legslam_tpu.utils.camera import CameraView
    w, h = int(q["w"]), int(q["h"])
    R, t = _orbit_pose(float(q.get("yaw", 0)), float(q.get("pitch", 0)),
                       float(q["r"]), np.zeros(3))
    view = CameraView.create(R, t, w, h, fx=0.7 * w, fy=0.7 * w)
    out = rasterize(st.params.xyz, st.sh(), st.params.lang_feat,
                    st.opacities(), st.scales(), st.params.rotation,
                    st.valid, view, jnp.zeros(3), 3, RasterizeConfig(),
                    include_lang_feat=False)
    return np.asarray(out.color)


@pytest.fixture(scope="module")
def ply_path(tmp_path_factory):
    from legslam_torch.utils import ply
    rng = np.random.default_rng(0)
    n = 32
    path = str(tmp_path_factory.mktemp("viewer") / "pc.ply")
    ply.save_gaussian_ply(
        path, rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        np.zeros((n, 15, 3), np.float32), np.zeros((n, 64), np.float32),
        np.zeros((n, 1), np.float32), np.full((n, 3), -1.5, np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))
    return path, n


def test_view_only_matches_jax(ply_path):
    from legslam_tpu.mapper.checkpoint import state_from_ply
    from legslam_torch.serving.viewer import ViewerServer
    path, n = ply_path
    v = ViewerServer(host="127.0.0.1", port=0, device="cpu")
    v.attach_ply(path)
    server, base = _serve(v)
    try:
        with urllib.request.urlopen(base + "/state", timeout=10) as r:
            assert json.load(r) == dict(mode="view_only", gaussians=n)
        with urllib.request.urlopen(base + "/render?w=128&h=64&r=4",
                                    timeout=120) as r:
            assert r.read()[:2] == b"\xff\xd8"   # JPEG magic
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert b"legslam live viewer" in r.read()
    finally:
        server.shutdown()
        server.server_close()
    st = state_from_ply(path, 256)
    # one image size: each size is one more JAX compilation
    for q in (dict(w="96", h="64", r="4"),
              dict(w="96", h="64", r="3", yaw="0.7", pitch="-0.3")):
        rgb = v.render_rgb(q)
        assert rgb.shape == (int(q["h"]), int(q["w"]), 3)
        assert rgb.max() > 0.05
        np.testing.assert_allclose(rgb, _jax_orbit_render(st, q), **FWD_TOL)


def test_mapper_render_matches(tmp_path):
    """A mapper's store, created alike in both packages from one point
    cloud: /render's array is the port mapper's render_from_pose bit for
    bit and JAX's within the forward tolerance."""
    from legslam_tpu.mapper.mapper import GaussianMapper as JaxMapper
    from legslam_tpu.models import gaussians as JG
    from legslam_tpu.serving.viewer import _orbit_pose
    from legslam_tpu.slam.interface import OperationQueue as JaxQueue
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.serving.viewer import ViewerServer
    from legslam_torch.slam.interface import OperationQueue
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    intr = dict(width=96, height=64, fx=80.0, fy=80.0, cx=47.5, cy=31.5)
    mt = GaussianMapper(OperationQueue(), intr, capacity=1 << 10,
                        result_dir=str(tmp_path), device="cpu")
    mt.state = G.create_from_pcd(pts, cols, 1 << 10, device="cpu")
    mj = JaxMapper(JaxQueue(), intr, capacity=1 << 10,
                   result_dir=str(tmp_path))
    mj.state = JG.create_from_pcd(pts, cols, 1 << 10)
    v = ViewerServer(mapper=mt, device="cpu")
    q = dict(w="96", h="64", r="3.5", yaw="0.4", pitch="0.2")
    rgb = v.render_rgb(q)
    R, t = _orbit_pose(0.4, 0.2, 3.5, np.zeros(3))
    np.testing.assert_array_equal(
        rgb, mt.render_from_pose(R, t, 96, 64).color.numpy())
    assert rgb.max() > 0.05
    np.testing.assert_allclose(
        rgb, np.asarray(mj.render_from_pose(R, t, 96, 64).color), **FWD_TOL)
    assert v._state()["gaussians"] == 300
    assert v._set_params({"lambda_dssim": 0.3, "bogus": 1}) == \
        dict(updated=["lambda_dssim"])
    assert mt.opt.lambda_dssim == 0.3


@pytest.fixture(scope="module")
def trackers(jax_native_pin):
    """Both packages' RGB-D trackers over the 4-frame scene of
    tests/test_aux_components.py:193, on the native route (the JAX one on
    the private build of tests/torch_native_pin.py)."""
    from legslam_tpu.data import datasets as JD
    from legslam_tpu.slam import tracking as JT
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam import tracking as TT
    mp = pytest.MonkeyPatch()
    mp.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    try:
        ds = SyntheticDataset(n_frames=4, width=128, height=64,
                              n_gaussians=1200, seed=3, clutter_ratio=0.0,
                              device="cpu")
        fj = JT.TrackingFrontend(ds.intrinsics, ransac_thresh=0.1,
                                 max_corners=200)
        ft = TT.TrackingFrontend(ds.intrinsics, ransac_thresh=0.1,
                                 max_corners=200, device="cpu")
        for frame in ds:
            ft.track(frame)
            fj.track(JD.RGBDFrame(index=frame.index,
                                  timestamp=frame.timestamp,
                                  color=frame.color, depth=frame.depth,
                                  c2w=frame.c2w))
    finally:
        mp.undo()
    return fj, ft


def test_slam_pane_and_overlay_match(trackers):
    from legslam_tpu.serving.viewer import ViewerServer as JaxViewer
    from legslam_torch.serving.viewer import ViewerServer
    fj, ft = trackers
    v, vj = ViewerServer(frontend=ft, device="cpu"), JaxViewer(frontend=fj)
    vis = v.slam_frame_input()
    assert vis is not None and len(vis["pts"]) > 0
    np.testing.assert_array_equal(vis["pts"], fj.last_vis["pts"])
    np.testing.assert_array_equal(vis["pts"], ft._track_px)
    jpeg = v._slam_frame()
    assert jpeg[:2] == b"\xff\xd8" and jpeg == vj._slam_frame()
    img = np.zeros((64, 128, 3), np.uint8)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    out = v._draw_map_overlay(img.copy(), R, t, 128, 64)
    assert out.shape == img.shape and (out != img).any()
    np.testing.assert_array_equal(
        out, vj._draw_map_overlay(img.copy(), R, t, 128, 64))


def test_jpeg_routes_raise_without_cv2(trackers, monkeypatch):
    from legslam_torch.serving import viewer as V
    _, ft = trackers
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    assert not V.jpeg_available()
    v = V.ViewerServer(frontend=ft, host="127.0.0.1", port=0, device="cpu")
    with pytest.raises(RuntimeError, match="cv2"):
        v._slam_frame()
    assert v.render_rgb(dict(w="32", h="16")).shape == (16, 32, 3)
    server, base = _serve(v)
    try:
        for route in ("/render?w=32&h=16", "/slam_frame"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + route, timeout=10)
            assert e.value.code == 500
            assert "cv2" in json.load(e.value)["error"]
        with urllib.request.urlopen(base + "/state", timeout=10) as r:
            assert json.load(r) == dict(mode="view_only", gaussians=0)
        req = urllib.request.Request(base + "/params", data=b"{}",
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.load(r) == dict(error="no mapper attached")
    finally:
        server.shutdown()
        server.server_close()


def test_main_takes_device(monkeypatch, ply_path):
    from legslam_torch.serving import viewer as V
    seen = {}

    class Stop(Exception):
        pass

    def fake_serve(self):
        seen["device"] = self.device
        seen["n"] = self._state()["gaussians"]
        raise Stop
    monkeypatch.setattr(V.ViewerServer, "serve", fake_serve)
    with pytest.raises(Stop):
        V.main(["--ply", ply_path[0], "--device", "cpu", "--port", "0"])
    assert seen == dict(device=torch.device("cpu"), n=ply_path[1])
    assert V.ViewerServer().device == torch.device("cuda")
