"""Offline scene optimization (C11: GaussianTrainer / trainColmap path).

Counterpart of legslam_tpu/apps/train_offline.py. The reference keeps a
legacy offline trainer that optimizes a scene from cached keyframes
without live SLAM (src/gaussian_trainer.cpp:20-156,
gaussian_mapper.cpp:556-618 trainColmap): load a dataset with known
poses, seed the store from depth-backprojected points, run the full 3DGS
schedule (densify from 500 to 15k, opacity reset every 3k, SH ramp),
report PSNR over held-out views, and write a checkpoint that both
packages load (mapper/checkpoint.py).

  python -m legslam_torch.apps.train_offline --data <scene> --out <dir> \\
      [--iterations 7000] [--eval-every 1000] [--test-hold 8] \\
      [--device cuda|cpu]

Compositing runs on the "cuda" backend with float32 pair features (the
kernels on the card; their plain versions on CPU tensors).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default="./output/offline")
    ap.add_argument("--iterations", type=int, default=7000)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--frame-stride", type=int, default=8)
    ap.add_argument("--test-hold", type=int, default=8,
                    help="every Nth keyframe held out for eval")
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from legslam_torch.config import OptimizationParams, RasterizeConfig
    from legslam_torch.data.datasets import open_dataset
    from legslam_torch.mapper.checkpoint import save_checkpoint
    from legslam_torch.mapper.keyframe import build_keyframe
    from legslam_torch.mapper.train_step import train_step
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops import losses
    from legslam_torch.ops.rasterize import rasterize
    from legslam_torch.slam.interface import KeyframePacket
    from legslam_torch.slam.trajectory import detect_keypoints

    device = torch.device(args.device)
    opt = OptimizationParams(iterations=args.iterations,
                             densify_until_iter=args.iterations // 2)
    cfg = RasterizeConfig(backend="cuda")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    ds = open_dataset(args.data)
    intr = ds.intrinsics
    fx, fy, cx, cy = intr["fx"], intr["fy"], intr["cx"], intr["cy"]

    # collect keyframes + seed point cloud from depth backprojection
    kfs, pts_all, col_all = [], [], []
    for frame in ds.iter_prefetched():
        if frame.index % args.frame_stride:
            continue
        w2c = np.linalg.inv(frame.c2w).astype(np.float32)
        packet = KeyframePacket(
            fid=frame.index, timestamp=frame.timestamp,
            R=w2c[:3, :3], t=w2c[:3, 3], color=frame.color,
            depth=frame.depth, lf_image=None)
        kfs.append(build_keyframe(packet, intr, 0, (), 0, 0, device=device))
        kp = detect_keypoints(frame.color, 600)
        if frame.depth is not None and len(kp):
            xi = np.clip(kp[:, 0].astype(int), 0, frame.color.shape[1] - 1)
            yi = np.clip(kp[:, 1].astype(int), 0, frame.color.shape[0] - 1)
            d = frame.depth[yi, xi]
            ok = d > 1e-4
            cam = np.stack([(kp[ok, 0] - cx) / fx * d[ok],
                            (kp[ok, 1] - cy) / fy * d[ok], d[ok]], -1)
            pts_all.append(((cam - w2c[:3, 3]) @ w2c[:3, :3]))
            col_all.append(frame.color[yi[ok], xi[ok]])
    pts = np.concatenate(pts_all).astype(np.float32)
    cols = np.concatenate(col_all).astype(np.float32)
    n = min(len(pts), args.capacity // 2)
    sel = rng.permutation(len(pts))[:n]
    state = G.create_from_pcd(pts[sel], cols[sel], args.capacity,
                              device=device)

    test_kfs = kfs[::args.test_hold]
    train_kfs = [k for i, k in enumerate(kfs) if i % args.test_hold]
    centers = np.stack([-(k.R.T @ k.t) for k in kfs])
    extent = float(np.linalg.norm(
        centers - centers.mean(0), axis=-1).max() * 1.1)
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def evaluate():
        psnrs = []
        for kf in test_kfs:
            out = rasterize(
                state.params.xyz, state.sh(), state.params.lang_feat,
                state.opacities(), state.scales(), state.params.rotation,
                state.valid, kf.views[-1], bg, active_sh, cfg,
                include_lang_feat=False)
            psnrs.append(float(losses.psnr(
                out.color.clamp(0, 1), kf.gt_color[-1])))
        return float(np.mean(psnrs))

    active_sh = 0
    big_points_on = False
    t0 = time.perf_counter()
    for it in range(1, args.iterations + 1):
        if it % opt.sh_degree_interval == 0 and active_sh < opt.sh_degree:
            active_sh += 1
        kf = train_kfs[rng.integers(len(train_kfs))]
        v = kf.views[-1]
        state, aux = train_step(
            state, v.world_view, v.full_proj, v.cam_center, v.tan_fovx,
            v.tan_fovy, kf.gt_color[-1], None, kf.gt_depth[-1], kf.mask[-1],
            bg, float(it), extent, width=v.width, height=v.height,
            active_sh_degree=active_sh, opt=opt, cfg=cfg,
            include_lang_feat=False)
        if it < opt.densify_until_iter:
            if opt.prune_big_point_after_iter and \
                    it > opt.prune_big_point_after_iter:
                big_points_on = True
            if it > opt.densify_from_iter and \
                    it % opt.densification_interval == 0:
                state = G.densify_and_prune(
                    state, gen, opt.densify_grad_threshold,
                    opt.densify_min_opacity, extent,
                    opt.max_screen_size if big_points_on else None,
                    opt.percent_dense)
            if opt.opacity_reset_interval and \
                    it % opt.opacity_reset_interval == 0:
                state = G.reset_opacity(state)
        if it % args.eval_every == 0 or it == args.iterations:
            psnr = evaluate()
            n_valid = int(state.num_valid())
            print(f"iter {it}: loss={float(aux.loss):.4f} "
                  f"test-PSNR={psnr:.2f} gaussians={n_valid} "
                  f"({(time.perf_counter()-t0):.0f}s)", flush=True)

    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "checkpoint.npz"), state,
                    meta=dict(iterations=args.iterations))
    print("saved", os.path.join(args.out, "checkpoint.npz"))


if __name__ == "__main__":
    main()
