#!/usr/bin/env python3
"""Where the time of legslam_torch's mapping step goes, on one CUDA card.

    python3 tools/profile_torch_step.py [--out build/profile_step.json]

Builds chip_smoke.py's main-path scene (1200x680, 200k gaussians in
capacity 2^18, bf16 pair features, binning refresh 8 with trim), runs two
warm-up refresh groups, then traces one group of 8 steps with
torch.profiler and prints: wall ms per step, device-busy ms per step (the
sum of the CUDA kernels' self time; one stream, so kernels do not
overlap), the idle share, and the kernels by self CUDA time per step. The
card's name and power limit go beside every number.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _self_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    raise AttributeError("profiler event has no self device time")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_step.json")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda")
    st, view, gt = cs.make_scene(dev, 1200, 680, 200_000, 1 << 18, seed=0)
    drv = cs.StepLoop(st, view, gt, cs.make_cfg(1 << 20, "bfloat16"))
    for _ in range(2):
        drv.group()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drv.group()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / drv.refresh
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key, "calls_per_step": e.count / drv.refresh,
                    "ms_per_step": _self_us(e) / 1e3 / drv.refresh}
                   for e in kernels), key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    if busy <= 0:
        print("profile_torch_step: the trace holds no device time",
              file=sys.stderr)
        return 1
    print(f"[profile] 1200x680 mapping step, refresh 8 + trim: wall "
          f"{wall_ms:.3f} ms/step, device busy {busy:.3f} ms/step, idle "
          f"share {1 - busy / wall_ms:.3f}, {len(rows)} kernel names "
          f"[{card}]")
    for r in rows[:args.top]:
        print(f"[profile] {r['ms_per_step']:9.3f} ms/step "
              f"{r['calls_per_step']:7.2f} calls/step  {r['name'][:100]}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, wall_ms_per_step=wall_ms,
                                   busy_ms_per_step=busy, kernels=rows),
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
