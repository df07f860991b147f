#!/usr/bin/env python3
"""Which synthetic rooms the visual tracker can follow at Replica's width:
the RGB-D TrackingFrontend (native route) over the 40-frame 1200x680
surface-only room of chip_smoke.py's [visual] phase (seed 3), at several
gaussian counts, orbit speeds and render paths, on one CUDA card.

    python3 tools/probe_visual_room.py

One line a configuration: the frames lost and where, the keyframes, the
Sim(3)-aligned and unaligned ATE against the hidden GT, the tracker's host
ms a frame, the frame's contrast (std) and its mean horizontal gradient a
pixel (the texture KLT and Shi-Tomasi see). The walls' gaussians all have
a 0.12 m scale, so more of them overlap into a smoother texture. The
render paths: the dataset's own (the "torch" compositor, max_per_tile
1024, span cap 4x8), and the "cuda" backend with max_pairs 2^23, and with
a 16x16 span cap and max_pairs 2^24 (nothing clipped).
"""
from __future__ import annotations

import os
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

# (n_gaussians, revolutions, render path)
CONFIGS = [(200_000, 0.15, "dataset"), (200_000, 0.05, "dataset"),
           (200_000, 0.15, "cuda 2^23"), (200_000, 0.15, "cuda span16 2^24"),
           (40_000, 0.15, "dataset"), (20_000, 0.15, "dataset"),
           (10_000, 0.15, "dataset")]


def render_cfg(path):
    from legslam_torch.config import RasterizeConfig
    base = dict(chunk=128, tile_batch=8)
    if path == "cuda 2^23":
        return RasterizeConfig(backend="cuda", max_pairs=1 << 23,
                               max_span_x=4, max_span_y=8, **base)
    if path == "cuda span16 2^24":
        return RasterizeConfig(backend="cuda", max_pairs=1 << 24,
                               max_span_x=16, max_span_y=16, **base)
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_visual_room: no CUDA device", file=sys.stderr)
        return 2
    os.environ["LEGSLAM_NATIVE_TRACKING"] = "1"
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam.tracking import TrackingFrontend
    dev = torch.device("cuda")
    card = smoke.card_line()
    for n, revs, path in CONFIGS:
        room = dict(smoke.VISUAL_ROOM, n_gaussians=n, revolutions=revs)
        ds = SyntheticDataset(**room, device=dev)
        cfg = render_cfg(path)
        if cfg is not None:
            ds._cfg = cfg
        frames = [ds.read(i) for i in range(len(ds))]
        fe = TrackingFrontend(ds.intrinsics, ransac_thresh=0.1, device=dev)
        lost_at, ms = [], []
        for f in frames:
            before = fe.lost_frames
            t0 = time.perf_counter()
            fe.track(smoke.hide_gt(f))
            ms.append((time.perf_counter() - t0) * 1e3)
            if fe.lost_frames > before:
                lost_at.append(f.index)
        ate_s, ate_r = smoke.traj_ate(fe, frames)
        gray = frames[0].color.mean(-1)
        grad = float(np.abs(np.diff(gray, axis=1)).mean())
        print(f"[room] {n} gaussians, {revs} revolution, render {path}: "
              f"lost {fe.lost_frames} at {lost_at}, keyframes "
              f"{fe.n_keyframes_created}, ATE Sim(3) {ate_s:.4f} m, "
              f"unaligned {ate_r:.4f} m, host ms a frame median "
              f"{statistics.median(ms):.2f}; frame 0 std "
              f"{float(frames[0].color.std()):.4f}, mean |dI/dx| {grad:.4f} "
              f"[{card}]", flush=True)
        del ds, frames
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
