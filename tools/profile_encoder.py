#!/usr/bin/env python3
"""Where the time of legslam_torch's language-feature encoder goes, on one
CUDA card.

    python3 tools/profile_encoder.py [--out build/profile_encoder.json]

Builds chip_smoke.py's seeded encoder (ViT-B/14-reg, 12 blocks, an
orthonormal 768 -> 64 PCA, bf16 weights with float32 arithmetic) and its
seeded 1200x680 frame, already on the card; runs 5 warm-up frames, then
traces 10 frames with torch.profiler and prints: wall ms a frame, device
busy ms a frame (the sum of the CUDA kernels' self time; one stream), the
idle share, and the kernels by self CUDA time a frame. The card's name
and power limit go beside every number.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from tools.profile_torch_step import _self_us  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_encoder.json")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_encoder: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda")
    enc, _ = cs.seeded_encoder(dev)
    frame = torch.as_tensor(np.random.default_rng(1).uniform(
        size=(680, 1200, 3)).astype(np.float32), device=dev)
    for _ in range(5):
        enc.create_language_features(frame)
    torch.cuda.synchronize()
    n = 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            enc.create_language_features(frame)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key, "calls_per_frame": e.count / n,
                    "ms_per_frame": _self_us(e) / 1e3 / n}
                   for e in kernels), key=lambda r: -r["ms_per_frame"])
    busy = sum(r["ms_per_frame"] for r in rows)
    if busy <= 0:
        print("profile_encoder: the trace holds no device time",
              file=sys.stderr)
        return 1
    print(f"[profile] encoder, 1200x680 frame on the card: wall "
          f"{wall_ms:.3f} ms/frame (traced), device busy {busy:.3f} "
          f"ms/frame, idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(r['calls_per_frame'] for r in rows):.0f} kernels a frame "
          f"[{card}]")
    for r in rows[:args.top]:
        print(f"[profile] {r['ms_per_frame']:9.3f} ms/frame "
              f"{r['calls_per_frame']:7.2f} calls/frame  {r['name'][:100]}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, wall_ms_per_frame=wall_ms,
                                   busy_ms_per_frame=busy, kernels=rows),
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
