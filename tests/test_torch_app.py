"""legslam_torch.apps.replica_rgbd end to end over an on-disk Replica
layout, on the CPU (the "cuda" backend's kernel wrappers run their plain
versions on CPU tensors), as tests/test_app_e2e.py drives the JAX app: a
tiny synthetic scene written as results/frame*.jpg + depth*.png +
traj.txt, the real CLI main(), and every artifact a reference run writes.
"""
import json
import os

import numpy as np
import pytest
import torch

from legslam_torch.data.synthetic import SyntheticDataset

torch.set_num_threads(1)

N_FRAMES = 10
W, H = 160, 96

FAST_ARGS = ["--kf-stride", "2", "--capacity", "4096", "--no-lf",
             "--iters-per-frame", "1", "--binning-refresh", "2",
             "--chunk", "64", "--tile-batch", "4", "--max-per-tile", "512",
             "--max-span-x", "3", "--max-span-y", "8", "--device", "cpu"]

MAPPER_YAML = """%YAML:1.0
Optimization.densification_interval: 20
Optimization.densify_from_iter: 8
Mapper.min_num_initial_map_kfs: 4
Mapper.new_keyframe_times_of_use: 4
"""


@pytest.fixture(scope="module")
def replica_scene(tmp_path_factory):
    """<scene>/results/frameNNNN.jpg + depthNNNN.png + traj.txt."""
    import cv2

    from legslam_torch.data.datasets import REPLICA_DEPTH_SCALE
    ds = SyntheticDataset(n_frames=N_FRAMES, width=W, height=H,
                          n_gaussians=2500, seed=7, clutter_ratio=0.0,
                          revolutions=0.2, device="cpu")
    scene = tmp_path_factory.mktemp("replica_office_tiny")
    res = scene / "results"
    res.mkdir()
    rows = []
    for i in range(N_FRAMES):
        f = ds.read(i)
        bgr = cv2.cvtColor((f.color * 255).astype(np.uint8),
                           cv2.COLOR_RGB2BGR)
        assert cv2.imwrite(str(res / f"frame{i:06d}.jpg"), bgr,
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
        d = np.clip(f.depth * REPLICA_DEPTH_SCALE, 0, 65535).astype(np.uint16)
        assert cv2.imwrite(str(res / f"depth{i:06d}.png"), d)
        rows.append(f.c2w.reshape(-1))
    np.savetxt(str(scene / "traj.txt"), np.stack(rows))
    return scene


def test_replica_layout_cli_end_to_end(replica_scene, tmp_path, capsys):
    from legslam_torch.apps.replica_rgbd import main
    from legslam_torch.data.datasets import ReplicaDataset, open_dataset
    from legslam_torch.utils import ply
    assert isinstance(open_dataset(str(replica_scene)), ReplicaDataset)
    cfg = tmp_path / "tiny_rgbd.yaml"
    cfg.write_text(MAPPER_YAML)
    out = str(tmp_path / "run")
    main(["--data", str(replica_scene), "--out", out, "--cfg", str(cfg)]
         + FAST_ARGS)
    text = capsys.readouterr().out
    for line in ("Total time:", "Average FPS:", "Keyframes: 5",
                 "PSNR-GS:", "Artifacts:"):
        assert line in text, text

    base = os.path.join(out, "experiment", "ply")
    data = ply.load_gaussian_ply(
        os.path.join(base, "point_cloud", "point_cloud.ply"))
    assert data["xyz"].shape[0] > 100
    assert data["lang_feat"].shape[1] == 64
    assert np.isfinite(data["xyz"]).all()
    assert os.path.exists(os.path.join(base, "input.ply"))
    with open(os.path.join(base, "cfg_args")) as f:
        assert "data_device='cpu'" in f.read()
    with open(os.path.join(base, "cameras.json")) as f:
        cams = json.load(f)
    assert len(cams) == 5 and {"fx", "position", "rotation"} <= set(cams[0])
    with open(os.path.join(out, "TrackingTime.txt")) as f:
        assert len(f.readlines()) == N_FRAMES
    with open(os.path.join(out, "GpuPeakUsageMB.txt")) as f:
        assert f.read() == "cpu peak_mb=not measured\n"
    tum = np.loadtxt(os.path.join(out, "CameraTrajectory_TUM.txt"))
    assert tum.shape == (5, 8)
    kitti = np.loadtxt(os.path.join(out, "CameraTrajectory_KITTI.txt"))
    assert kitti.shape == (5, 12)
    euroc = np.loadtxt(os.path.join(out, "CameraTrajectory_EuRoC.txt"))
    assert euroc.shape == (5, 8)
    # the trajectory files hold the input poses (GT-pose frontend)
    traj = np.loadtxt(str(replica_scene / "traj.txt")).reshape(-1, 4, 4)
    np.testing.assert_allclose(kitti[1].reshape(3, 4), traj[2][:3],
                               atol=1e-5)
    exp = os.path.join(out, "experiment")
    psnrs = np.atleast_1d(np.loadtxt(
        os.path.join(exp, "psnr_gaussian_splatting.txt")))
    assert psnrs.shape == (5,)
    assert np.atleast_1d(np.loadtxt(os.path.join(exp, "dssim.txt"))).shape \
        == (5,)
    assert np.atleast_1d(np.loadtxt(
        os.path.join(exp, "render_time.txt"))).shape == (5,)
    # jpg-lossy GT and ~20 iterations: a loose floor, the check is that
    # training ran and rendered something resembling the inputs
    assert float(psnrs.mean()) > 12.0, psnrs


@pytest.mark.parametrize("flags", [["--n-views", "2"],
                                   ["--spatial-strips", "2"],
                                   ["--shard-store"],
                                   ["--n-buckets", "2", "--bucket-cap", "1024",
                                    "--p-slabs", "8", "--no-ellipse-cull"]])
def test_unported_options_raise(replica_scene, tmp_path, capsys, flags):
    """The options that raised before the multi-view, strip and sharded
    paths were ported now run the app to its end (6 frames), as do the
    bucketed layout, the slab skip and the cull switch."""
    from legslam_torch.apps.replica_rgbd import main
    cfg = tmp_path / "tiny_rgbd.yaml"
    # a 4-iteration tail (0.8 x the densification interval)
    cfg.write_text(MAPPER_YAML.replace("densification_interval: 20",
                                       "densification_interval: 5"))
    out = str(tmp_path / "run")
    main(["--data", str(replica_scene), "--out", out, "--max-frames", "6",
          "--cfg", str(cfg)] + FAST_ARGS + flags)
    text = capsys.readouterr().out
    assert "Keyframes: 3" in text and "PSNR-GS:" in text, text
    psnrs = np.atleast_1d(np.loadtxt(os.path.join(
        out, "experiment", "psnr_gaussian_splatting.txt")))
    assert psnrs.shape == (3,) and np.isfinite(psnrs).all()


VISUAL_FRAMES = 6


def _right_view(color, depth, fx, baseline):
    """A rectified right view, right(u) = left(u + fx*b/z), as
    tests/test_tracking_stereo.py:21-35 warps it."""
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


class _Recorded:
    """Wraps the visual TrackingFrontend the app builds, recording its
    sensor mode and the track() keywords it receives."""

    def __init__(self, monkeypatch):
        from legslam_torch.slam import tracking
        rec = self
        self.frontends, self.calls = [], []

        class Recording(tracking.TrackingFrontend):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.frontends.append(self)

            def track(self, frame, **kw):
                rec.calls.append(kw)
                return super().track(frame, **kw)
        monkeypatch.setattr(tracking, "TrackingFrontend", Recording)
        monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")


@pytest.mark.parametrize("sensor", ["rgbd", "mono", "mono-inertial"])
def test_visual_frontend_end_to_end(replica_scene, tmp_path, capsys,
                                    monkeypatch, sensor):
    """--frontend visual on the Replica layout: the tracker's own poses
    drive the mapper, in each sensor mode the layout allows (it has no IMU
    stream, so the inertial mode tracks without one; the stereo modes are
    the EuRoC case below)."""
    from legslam_torch.apps.replica_rgbd import main
    rec = _Recorded(monkeypatch)
    cfg = tmp_path / "tiny_rgbd.yaml"
    cfg.write_text(MAPPER_YAML)
    out = str(tmp_path / "run")
    main(["--data", str(replica_scene), "--out", out, "--cfg", str(cfg),
          "--frontend", "visual", "--sensor", sensor, "--max-frames",
          str(VISUAL_FRAMES)] + FAST_ARGS)
    text = capsys.readouterr().out
    assert "Average FPS:" in text and "PSNR-GS:" in text, text
    (fe,) = rec.frontends
    assert fe.sensor == sensor.split("-")[0]
    assert fe.use_imu == sensor.endswith("-inertial")
    assert fe.device == torch.device("cpu")
    assert len(rec.calls) == VISUAL_FRAMES
    assert all(c["imu"] is None and c["color_right"] is None
               for c in rec.calls)
    assert fe.n_keyframes_created >= 2
    tum = np.loadtxt(os.path.join(out, "CameraTrajectory_TUM.txt"))
    assert tum.ndim == 2 and tum.shape[1] == 8 and np.isfinite(tum).all()
    # the trajectory files hold the tracker's poses, not the input GT
    est = {int(f) for f in fe.keyframes}
    assert len(tum) <= max(len(est), fe.n_keyframes_created)


@pytest.mark.parametrize("sensor", ["stereo", "auto"])
def test_euroc_stereo_cli_end_to_end(tmp_path, monkeypatch, sensor):
    """The EuRoC layout through --frontend visual --camera-cfg, as
    tests/test_app_e2e.py:168 drives the JAX app: the stereo tracker's SGM
    depth and the mapper's SGM densify build the map. "auto" sniffs the
    layout's stereo pairs and IMU stream: stereo-inertial, fed the IMU
    rows between frames (ds.imu_between)."""
    from legslam_torch.apps.replica_rgbd import main
    from legslam_torch.data.datasets import EuRoCStereoDataset, open_dataset
    from legslam_torch.utils import ply
    from tests.test_app_e2e import CAMERA_YAML_TMPL
    from tests.util import make_euroc_dir
    rec = _Recorded(monkeypatch)
    # at 160x96 (fx 128) a 1 m baseline puts the walls (z 4-8 m) at 16-32
    # px of disparity, inside SGM's [8, 128) window
    n, baseline = 6, 1.0
    ds = SyntheticDataset(n_frames=n, width=W, height=H, n_gaussians=4000,
                          seed=11, clutter_ratio=0.0, revolutions=0.1,
                          device="cpu")
    fx = ds.intrinsics["fx"]
    frames = [(f.color, _right_view(f.color, f.depth, fx, baseline), f.c2w)
              for f in ds]
    scene = make_euroc_dir(tmp_path, n=n, width=W, height=H,
                           baseline=baseline, frames=frames,
                           intrinsics=(fx, ds.intrinsics["fy"],
                                       ds.intrinsics["cx"],
                                       ds.intrinsics["cy"]),
                           distortion=(0.0, 0.0, 0.0, 0.0))
    assert isinstance(open_dataset(scene), EuRoCStereoDataset)
    cam_yaml = tmp_path / "stereo_cam.yaml"
    cam_yaml.write_text(CAMERA_YAML_TMPL.format(
        fx=fx, fy=ds.intrinsics["fy"], cx=ds.intrinsics["cx"],
        cy=ds.intrinsics["cy"], w=W, h=H, b=baseline))
    cfg = tmp_path / "tiny_rgbd.yaml"
    cfg.write_text(MAPPER_YAML)
    out = str(tmp_path / "run")
    main(["--data", scene, "--out", out, "--cfg", str(cfg),
          "--camera-cfg", str(cam_yaml), "--frontend", "visual",
          "--sensor", sensor] + FAST_ARGS)
    (fe,) = rec.frontends
    assert fe.sensor == "stereo" and fe.stereo_baseline == baseline
    assert fe.use_imu == (sensor == "auto")
    assert all(c["color_right"] is not None for c in rec.calls)
    imus = [c["imu"] for c in rec.calls]
    if sensor == "auto":
        assert all(x is not None and x.shape[1] == 7 for x in imus[1:])
    else:
        assert all(x is None for x in imus)
    data = ply.load_gaussian_ply(os.path.join(
        out, "experiment", "ply", "point_cloud", "point_cloud.ply"))
    assert data["xyz"].shape[0] > 100
    assert os.path.exists(os.path.join(out, "CameraTrajectory_TUM.txt"))


def test_run_scene_visual_frontend(tmp_path, monkeypatch):
    """eval_harness.replica_eval.run_scene(frontend="visual"): GT hidden
    from the tracker, ATE scored against it (non-vacuous, and within the
    bar of tests/test_eval_visual_frontend.py)."""
    from legslam_torch.config import (MapperParams, OptimizationParams,
                                      RasterizeConfig)
    from legslam_torch.eval_harness import replica_eval
    monkeypatch.setenv("LEGSLAM_NATIVE_TRACKING", "1")
    ds = SyntheticDataset(n_frames=12, width=160, height=96,
                          n_gaussians=2500, seed=7, clutter_ratio=0.0,
                          revolutions=0.12, device="cpu")
    monkeypatch.setattr(replica_eval, "open_dataset", lambda path: ds)
    r = replica_eval.run_scene(
        "synthetic", str(tmp_path / "out"),
        opt=OptimizationParams(densify_from_iter=10,
                               densification_interval=40,
                               opacity_reset_interval=0),
        mp=MapperParams(min_num_initial_map_kfs=3, depth_cache=2),
        cfg=RasterizeConfig(backend="cuda", tile_batch=4, chunk=64,
                            max_span_x=3, max_span_y=8),
        capacity=1 << 12, frontend="visual",
        frontend_kwargs=dict(ransac_thresh=0.1), return_mapper=True,
        device="cpu")
    assert 1e-6 < r["ate_rmse"] < 0.2, r
    assert np.isfinite(r["psnr"]) and r["psnr"] > 10.0, r
    assert r["n_gaussians"] > 0
    assert r["_mapper"].device == torch.device("cpu")


# the small DINOv2 of the JAX suite (tests/test_dinov2.py): 56x56 input,
# a 4x4 grid of 64-D features after a 64 -> 64 PCA
SMALL = dict(image_size=56, patch_size=14, dim=64, depth=2, heads=2,
             num_registers=4, pos_grid=4)


def _small_weights(out_dir):
    """A seeded small-config dinov2.npz + pca.npz in `out_dir`, written
    by the port's save_params / pca.save."""
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import pca as PCA
    from legslam_torch.models.weights_io import save_params
    dino = D.init_params(D.DinoV2Config(**SMALL),
                         torch.Generator().manual_seed(5), device="cpu")
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(64, 64)))
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, "dinov2.npz"), dino)
    PCA.save(os.path.join(out_dir, "pca.npz"), PCA.PCAParams(
        torch.zeros(64), torch.as_tensor(q, dtype=torch.float32)))
    return out_dir


def test_encoder_weights_end_to_end(replica_scene, tmp_path, monkeypatch,
                                    capsys):
    """--encoder-weights runs the encoder on every frame inside the app's
    own loop (process_frame), and every keyframe keeps exactly the grid
    the encoder gave for its frame. The full ViT-B is too slow for a CPU
    test, so load_encoder is given the small config."""
    import functools

    from legslam_torch.apps import replica_rgbd
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import weights_io
    wdir = _small_weights(str(tmp_path / "weights"))
    monkeypatch.setattr(weights_io, "load_encoder", functools.partial(
        weights_io.load_encoder, cfg=D.DinoV2Config(**SMALL)))
    seen = {}
    frame_step = replica_rgbd.process_frame

    def recording(frame, frontend, mapper, encoder=None, **kw):
        lf = frame_step(frame, frontend, mapper, encoder, **kw)
        seen[frame.index] = (frame.color, lf, encoder, mapper)
        return lf
    monkeypatch.setattr(replica_rgbd, "process_frame", recording)
    cfg = tmp_path / "tiny_rgbd.yaml"
    cfg.write_text(MAPPER_YAML)
    args = [a for a in FAST_ARGS if a != "--no-lf"]
    replica_rgbd.main(["--data", str(replica_scene), "--out",
                       str(tmp_path / "run"), "--cfg", str(cfg),
                       "--encoder-weights", wdir] + args)
    assert "Keyframes: 5" in capsys.readouterr().out
    assert sorted(seen) == list(range(N_FRAMES))
    encoder, mapper = seen[0][2], seen[0][3]
    assert encoder is not None and encoder.dtype == torch.bfloat16
    assert sorted(mapper.keyframes) == [0, 2, 4, 6, 8]
    for fid, kf in mapper.keyframes.items():
        color, lf, _, _ = seen[fid]
        assert lf.shape == (4, 4, 64) and lf.dtype == torch.float32
        assert torch.equal(kf.gt_lf, lf)
        assert torch.equal(kf.gt_lf, encoder.create_language_features(color))
    # the map's language features were trained (they start at zero)
    assert float(mapper.state.params.lang_feat.abs().max()) > 0.0

