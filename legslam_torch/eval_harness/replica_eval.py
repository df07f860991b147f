"""Replica evaluation harness (C26: eval/replica_test.py equivalent).

Counterpart of legslam_tpu/eval_harness/replica_eval.py. For each scene:
run the online mapping pipeline (trajectory frontend + mapper, with the
language-feature encoder when one is given) through the app's own
per-frame loop (apps/replica_rgbd.process_frame), then re-render every
keyframe and score PSNR / SSIM / depth-L1(cm) / ATE-RMSE, writing
`eval_result_<EXP>.log` (eval/replica_test.py:131-240,317-337) in the JAX
module's format.

With `lpips_weights` (an lpips_alex.npz) each keyframe is also scored by
LPIPS(alex) (models/lpips.py) on the mapper's device. `frontend="visual"`
runs the KLT+RANSAC tracker (slam/tracking.py) with GT poses hidden, so
ate_rmse scores its retro-corrected trajectory against the withheld GT.
"""
from __future__ import annotations

import dataclasses
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
from legslam_torch.slam.tracking import TrackingFrontend
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

    frontend: "trajectory" plays back GT poses (ATE is then 0 by
    construction); "visual" runs the tracking frontend (its stereo SGM on
    `device`) with GT poses hidden, so ate_rmse measures real tracking
    drift. LF images come from `encoder` (on its device) or else
    `lf_loader(frame)`. Without `cfg` the mapper trains and renders on the
    "cuda" backend with float32 pair features: the kernels on a card,
    their plain versions on CPU tensors (JAX's harness renders with its
    XLA reference compositor).
    """
    if cfg is None:
        cfg = RasterizeConfig(backend="cuda", mm_dtype="float32")
    ds = open_dataset(scene_dir)
    if frontend == "visual":
        fe = TrackingFrontend(ds.intrinsics, **{"device": device,
                                                **(frontend_kwargs or {})})
    elif frontend == "trajectory":
        fe = TrajectoryFrontend(ds.intrinsics, kf_stride=kf_stride,
                                **(frontend_kwargs or {}))
    else:
        raise ValueError(f"unknown frontend {frontend!r}")
    mapper = GaussianMapper(fe.queue, ds.intrinsics, opt=opt, mp=mp,
                            cfg=cfg, capacity=capacity, result_dir=out_dir,
                            device=device)

    n = len(ds) if max_frames is None else min(len(ds), max_frames)
    t_start = time.perf_counter()
    est_centers, gt_centers = [], []
    gt_by_fid = {}
    it = iter(ds.iter_prefetched())
    for _ in range(n):
        frame = next(it)
        lf = lf_loader(frame) if encoder is None and lf_loader is not None \
            else None
        if frontend == "visual" and frame.c2w is not None:
            # hide GT from the tracker; keep it for ATE scoring
            gt_by_fid[frame.index] = frame.c2w[:3, 3]
            frame = dataclasses.replace(frame, c2w=None)
        # the reference trains concurrently; serial equivalent: a fixed
        # number of mapper ticks per frame
        process_frame(frame, fe, mapper, encoder, lf, iterations_per_frame)
        if frontend != "visual" and frame.c2w is not None:
            gt_centers.append(frame.c2w[:3, 3])
            est_centers.append(frame.c2w[:3, 3])  # GT-pose frontend: exact
    if frontend == "visual":
        # retro-corrected (BA/loop) trajectory vs the withheld GT
        fids, c2w = fe.trajectory()
        for f, T in zip(fids, c2w):
            if int(f) in gt_by_fid:
                est_centers.append(T[:3, 3])
                gt_centers.append(gt_by_fid[int(f)])
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
    lpips_params = None
    if lpips_weights:
        from legslam_torch.models import lpips as L
        lpips_params = L.load_params(lpips_weights, mapper.device)
    psnrs, ssims, depth_l1, lpipses = [], [], [], []
    for fid, kf in sorted(mapper.keyframes.items()):
        out = mapper.render_from_pose(kf.R, kf.t, kf.views[-1].width,
                                      kf.views[-1].height)
        gt = kf.gt_color[-1]
        pred = out.color.clamp(0, 1)
        psnrs.append(float(losses.psnr(pred, gt)))
        ssims.append(float(losses.ssim(pred, gt)))
        depth_l1.append(metrics.depth_l1_cm(
            out.depth.cpu().numpy(), kf.gt_depth[-1].cpu().numpy()))
        if lpips_params is not None:
            lpipses.append(float(L.lpips(lpips_params, pred, gt)))

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
    if lpipses:
        result["lpips"] = float(np.mean(lpipses))
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
