"""Replica evaluation harness (C26: eval/replica_test.py equivalent).

Counterpart of legslam_tpu/eval_harness/replica_eval.py. For each scene:
run the online mapping pipeline (trajectory frontend + mapper, with the
language-feature encoder when one is given) through the app's own
per-frame loop (apps/replica_rgbd.process_frame), then re-render every
keyframe and score PSNR / SSIM / depth-L1(cm) / ATE-RMSE, writing
`eval_result_<EXP>.log` (eval/replica_test.py:131-240,317-337) in the JAX
module's format.

Not ported yet (they raise, see ROADMAP.md): `frontend="visual"` (the
KLT+RANSAC tracker, slam/tracking.py) and `lpips_weights`
(models/lpips.py).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from legslam_torch.apps.replica_rgbd import process_frame
from legslam_torch.config import (MapperParams, OptimizationParams,
                                  RasterizeConfig)
from legslam_torch.data.datasets import open_dataset
from legslam_torch.eval_harness import metrics
from legslam_torch.mapper.mapper import GaussianMapper
from legslam_torch.ops import losses
from legslam_torch.slam.trajectory import TrajectoryFrontend

REPLICA_SCENES = ("office0", "office1", "office2", "office3", "office4",
                  "room0", "room1", "room2")


def run_scene(scene_dir: str, out_dir: str,
              opt: Optional[OptimizationParams] = None,
              mp: Optional[MapperParams] = None,
              cfg: Optional[RasterizeConfig] = None,
              kf_stride: int = 8, capacity: int = 1 << 18,
              max_frames: Optional[int] = None,
              encoder=None, iterations_per_frame: int = 1,
              return_mapper: bool = False,
              lf_loader=None,
              lpips_weights: Optional[str] = None,
              frontend: str = "trajectory",
              frontend_kwargs: Optional[dict] = None,
              device: str | torch.device = "cuda") -> dict:
    """Online mapping over one scene on `device`; returns metrics + timing.
    The frontend plays back GT poses, so ATE is 0 by construction. LF
    images come from `encoder` (on its device) or else `lf_loader(frame)`.
    """
    if frontend != "trajectory":
        raise NotImplementedError(
            f"frontend={frontend!r}: slam/tracking.py is not ported to "
            "legslam_torch yet; see ROADMAP.md")
    if lpips_weights:
        raise NotImplementedError(
            "lpips_weights: models/lpips.py is not ported to legslam_torch "
            "yet; see ROADMAP.md")
    ds = open_dataset(scene_dir)
    fe = TrajectoryFrontend(ds.intrinsics, kf_stride=kf_stride,
                            **(frontend_kwargs or {}))
    mapper = GaussianMapper(fe.queue, ds.intrinsics, opt=opt, mp=mp,
                            cfg=cfg, capacity=capacity, result_dir=out_dir,
                            device=device)

    n = len(ds) if max_frames is None else min(len(ds), max_frames)
    t_start = time.perf_counter()
    est_centers, gt_centers = [], []
    it = iter(ds.iter_prefetched())
    for _ in range(n):
        frame = next(it)
        lf = lf_loader(frame) if encoder is None and lf_loader is not None \
            else None
        # the reference trains concurrently; serial equivalent: a fixed
        # number of mapper ticks per frame
        process_frame(frame, fe, mapper, encoder, lf, iterations_per_frame)
        if frame.c2w is not None:
            gt_centers.append(frame.c2w[:3, 3])
            est_centers.append(frame.c2w[:3, 3])  # GT-pose frontend: exact
    fe.finish()
    total = time.perf_counter() - t_start
    fps = n / total

    # the feed is done; force map init if the threshold was never crossed
    # mid-run (short sequences / sparse keyframe decisions)
    mapper.drain_operations(limit=10_000)
    if mapper.state is None and len(mapper.keyframes):
        mapper.initialize_map()

    # tail optimization
    for _ in range(int(0.8 * mapper.opt.densification_interval)):
        mapper.train_iteration()

    # per-keyframe photometric metrics
    psnrs, ssims, depth_l1 = [], [], []
    for fid, kf in sorted(mapper.keyframes.items()):
        out = mapper.render_from_pose(kf.R, kf.t, kf.views[-1].width,
                                      kf.views[-1].height)
        gt = kf.gt_color[-1]
        pred = out.color.clamp(0, 1)
        psnrs.append(float(losses.psnr(pred, gt)))
        ssims.append(float(losses.ssim(pred, gt)))
        depth_l1.append(metrics.depth_l1_cm(
            out.depth.cpu().numpy(), kf.gt_depth[-1].cpu().numpy()))

    ate = metrics.ate_rmse(np.asarray(est_centers), np.asarray(gt_centers)) \
        if len(est_centers) >= 3 else dict(rmse=0.0, mean=0.0)

    base = mapper.save("experiment")
    result = dict(
        scene=os.path.basename(scene_dir), frames=n, fps=round(fps, 3),
        total_time_s=round(total, 2),
        psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)),
        depth_l1_cm=float(np.mean(depth_l1)),
        ate_rmse=ate["rmse"], ate_mean=ate["mean"],
        n_gaussians=int(mapper.state.num_valid()), output=base)
    if return_mapper:
        result["_mapper"] = mapper
    return result


def evaluate_scenes(data_root: str, out_root: str,
                    scenes=REPLICA_SCENES, exp_name: str = "legslam_torch",
                    **kwargs) -> list[dict]:
    """Train+score each scene; writes eval_result_<EXP>.log
    (eval/replica_test.py:317-337 layout)."""
    results = []
    for scene in scenes:
        scene_dir = os.path.join(data_root, scene)
        if not os.path.isdir(scene_dir):
            continue
        out_dir = os.path.join(out_root, scene)
        results.append(run_scene(scene_dir, out_dir, **kwargs))
    log_path = os.path.join(out_root, f"eval_result_{exp_name}.log")
    os.makedirs(out_root, exist_ok=True)
    with open(log_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
        if results:
            avg = {k: float(np.mean([r[k] for r in results]))
                   for k in ("fps", "psnr", "ssim", "depth_l1_cm",
                             "ate_rmse")}
            f.write(json.dumps(dict(average=avg)) + "\n")
    return results
