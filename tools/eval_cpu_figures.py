#!/usr/bin/env python3
"""CPU measurements behind chip_smoke.py phase 12's tolerances, its time
and its offline-trainer finding; no card needed.

    python3 tools/eval_cpu_figures.py step        # ~2 min
    python3 tools/eval_cpu_figures.py ae          # ~10 s
    python3 tools/eval_cpu_figures.py jpeg        # ~5 s
    python3 tools/eval_cpu_figures.py offline     # ~3 min
    python3 tools/eval_cpu_figures.py jax-render  # ~4 min, imports JAX
    python3 tools/eval_cpu_figures.py pamr        # ~10 s

step: one train_step of the 1200x680 bench scene (chip_smoke.make_scene,
32k gaussians in capacity 2^18, no LF) on the "cuda" backend's plain
versions, as [offline] replays the trainer's first step on the host, with
torch.profiler's CPU time by operator. ae: models/autoencoder's training
on four seeded 1369x768 unit feature batches in float32 against the same
training in float64, and across CPU thread counts (AE_ATOL's basis).
jpeg: the mean |err| of the Replica and ScanNet layouts' quality-95 JPEG
round trip at 128x64 (tests/test_torch_eval_layouts.py's bound).
offline: apps/train_offline on eval_room's frames at 160x96 (a sparse
seed: the 16-px keypoint grid gives 60 points a keyframe), 300 steps,
with the seeded store's test-PSNR. jax-render: the JAX package's
run_scene(cfg=None) on tests/test_torch_app.py's tiny Replica layout, the
seconds of its first keyframe render at max_per_tile 2048 and 256.
pamr: chip_smoke.detect_phase on the CPU ("cuda" backend's plain versions
against the "torch" compositor) on tests/test_torch_query_cuda.py's
flat-colored wall scene: the heats with each render's own RGB as PAMR's
guide against those with one shared guide (the [detect] gate's basis; its
launch gates fail on the CPU, as they should).
"""
from __future__ import annotations

import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def step():
    from torch.profiler import ProfilerActivity, profile

    from legslam_torch.config import OptimizationParams, RasterizeConfig
    from legslam_torch.mapper.train_step import train_step
    dev = torch.device("cpu")
    st, view, gt = smoke.make_scene(dev, 1200, 680, 32_000, 1 << 18, seed=0)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, aux = train_step(
            st, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, gt["gt_color"], None,
            gt["gt_depth"], gt["mask"], gt["bg"], 1.0, 1.0, width=1200,
            height=680, active_sh_degree=0, opt=OptimizationParams(),
            cfg=RasterizeConfig(backend="cuda"), include_lang_feat=False)
    print(f"train_step at 1200x680, 32000 gaussians, {int(aux.num_rendered)}"
          f" pairs, {torch.get_num_threads()} threads: "
          f"{time.perf_counter() - t0:.1f} s")
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=6))


def ae():
    from legslam_torch.models import autoencoder as AE
    rng = np.random.default_rng(0)
    f = rng.normal(size=(4, 1369, 768)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    runs = {}
    for threads in (1, 8):
        torch.set_num_threads(threads)
        runs[threads] = AE.train_autoencoder(
            list(f), torch.Generator().manual_seed(0), device="cpu")
    params = [t.double().requires_grad_()
              for t in AE.init(torch.Generator().manual_seed(0),
                               device="cpu")]
    opt = torch.optim.Adam(params, lr=1e-3)
    p = AE.AEParams(*params)
    for _ in range(5):
        for b in f:
            b = torch.as_tensor(b, dtype=torch.float64)
            opt.zero_grad(set_to_none=True)
            torch.mean((AE.decode(p, AE.encode(p, b)) - b) ** 2).backward()
            opt.step()

    def gap(a, b):
        return max(float((x.detach().double() - y.detach()).abs().max())
                   for x, y in zip(a, b))
    print(f"train_autoencoder parameters max|err|: float32 vs float64 "
          f"{gap(runs[1], params):.3g}; 1 vs 8 CPU threads "
          f"{gap(runs[1], runs[8]):.3g}")


def jpeg():
    from legslam_torch.data.datasets import open_dataset
    from legslam_torch.data.synthetic import SyntheticDataset
    smoke.EVAL_ROOM = dict(n_frames=4, width=128, height=64,
                           n_gaussians=600, seed=0)
    smoke.MIOU_ROOM = dict(n_frames=4, width=128, height=64,
                           n_gaussians=600, seed=5, clutter_ratio=0.0)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        frames, _, _ = smoke.eval_room(cpu)
        ds = open_dataset(smoke.write_replica(pathlib.Path(d) / "r", frames))
        rep = max(float(np.abs(ds.read(i).color - f.color).mean())
                  for i, f in enumerate(frames))
        scene, _, _ = smoke.miou_scene(cpu, pathlib.Path(d) / "s")
        src = SyntheticDataset(**smoke.MIOU_ROOM, device="cpu")
        ds = open_dataset(scene)
        sc = max(float(np.abs(ds.read(i).color - src.read(i).color).mean())
                 for i in range(4))
    print(f"JPEG mean |err| a frame, at most: Replica {rep:.4f}, "
          f"ScanNet {sc:.4f}")


def offline():
    from legslam_torch.apps import train_offline
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.mapper import train_step as TS
    from legslam_torch.slam import trajectory
    smoke.EVAL_ROOM = dict(n_frames=40, width=160, height=96,
                           n_gaussians=20_000, seed=0)
    cpu = torch.device("cpu")
    frames, _, _ = smoke.eval_room(cpu)
    spy = smoke.StepSpy(TS.train_step, cpu)
    TS.train_step, trajectory._HAS_CV2 = spy, False
    try:
        with tempfile.TemporaryDirectory() as d:
            scene = smoke.write_replica(pathlib.Path(d) / "room0", frames)
            train_offline.main([
                "--data", scene, "--out", str(pathlib.Path(d) / "out"),
                "--iterations", "300", "--frame-stride", "4",
                "--eval-every", "100", "--capacity", str(1 << 14),
                "--device", "cpu"])
            seeded = smoke.seeded_test_psnr(
                scene, spy.first[0], 4, 8, RasterizeConfig(backend="cuda"),
                cpu)
    finally:
        TS.train_step = spy.step
    print(f"seeded store {int(spy.first[0].num_valid())} gaussians, "
          f"test-PSNR {seeded:.2f}")


def jax_render():
    import cv2

    from legslam_torch.data.datasets import REPLICA_DEPTH_SCALE
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_tpu import config as JC
    from legslam_tpu.eval_harness import replica_eval as JE
    from legslam_tpu.mapper import mapper as JM
    with tempfile.TemporaryDirectory() as d:
        # tests/test_torch_app.py's replica_scene fixture
        ds = SyntheticDataset(n_frames=10, width=160, height=96,
                              n_gaussians=2500, seed=7, clutter_ratio=0.0,
                              revolutions=0.2, device="cpu")
        res = pathlib.Path(d) / "results"
        res.mkdir()
        for i in range(10):
            f = ds.read(i)
            cv2.imwrite(str(res / f"frame{i:06d}.jpg"), cv2.cvtColor(
                (f.color * 255).astype(np.uint8), cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
            cv2.imwrite(str(res / f"depth{i:06d}.png"), np.clip(
                f.depth * REPLICA_DEPTH_SCALE, 0, 65535).astype(np.uint16))
        np.savetxt(pathlib.Path(d) / "traj.txt",
                   np.stack([ds.read(i).c2w.reshape(-1) for i in range(10)]))
        for mpt in (2048, 256):
            secs = []
            render = JM.GaussianMapper.render_from_pose

            def timed(self, *a, **k):
                t0 = time.perf_counter()
                out = render(self, *a, **k)
                out.color.block_until_ready()
                secs.append(time.perf_counter() - t0)
                return out

            class Capped(JM.GaussianMapper):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k, max_per_tile=mpt)
            JE.GaussianMapper, JM.GaussianMapper.render_from_pose = \
                Capped, timed
            try:
                r = JE.run_scene(
                    d, str(pathlib.Path(d) / f"out{mpt}"), kf_stride=2,
                    capacity=4096, max_frames=6,
                    opt=JC.OptimizationParams(densify_from_iter=1000,
                                              densification_interval=5),
                    mp=JC.MapperParams(min_num_initial_map_kfs=2,
                                       do_gaus_pyramid_training=False))
            finally:
                JE.GaussianMapper = JM.GaussianMapper
                JM.GaussianMapper.render_from_pose = render
            print(f"max_per_tile {mpt}: first render {secs[0]:.1f} s, psnr "
                  f"{r['psnr']:.6f}, ssim {r['ssim']:.6f}")


def pamr():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] /
                           "tests"))
    from test_torch_query_cuda import write_wall_scene
    with tempfile.TemporaryDirectory() as d:
        write_wall_scene(str(pathlib.Path(d) / "exp"))
        fails = []
        smoke.detect_phase(torch.device("cpu"), "CPU", fails,
                           str(pathlib.Path(d) / "exp"),
                           str(pathlib.Path(d) / "detect"))
    print(f"gates failed on the CPU: {fails}")


PARTS = {"step": step, "ae": ae, "jpeg": jpeg, "offline": offline,
         "jax-render": jax_render, "pamr": pamr}

if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in PARTS:
        sys.exit(f"usage: {sys.argv[0]} {{{'|'.join(PARTS)}}}")
    PARTS[sys.argv[1]]()
