#!/usr/bin/env python3
"""Time legslam_torch's radix sort kernels at the main path's shapes, on
one CUDA card, beside torch.sort.

    python3 tools/profile_sort.py

Inputs (chip_smoke.py's main-path scene: 1200x680, 200k gaussians in
capacity 2^18): the [2^23] pair-key buffer as bin_gaussians sorts it
(key_bits of the sentinel), the 2^18 depth keys of argsort_f32, and 2^23
random (key, value) pairs for the lexicographic sort_kv. Each kernel is
checked bit for bit against its plain version, then the kernels and
torch.sort are timed in turns (kernels, torch.sort, torch.sort, kernels)
with CUDA events; the host time a call takes to enqueue, without
synchronising; then torch.profiler splits a call into its kernels
(histogram, onesweep passes, the workspace fill) and torch.sort's into
its own. The card's name, power limit and SM clock go beside the numbers.
"""
from __future__ import annotations

import pathlib
import statistics
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def inputs(dev):
    """(pair keys, their key_bits, depth bits, random keys, random values)
    at the main path's shapes."""
    from legslam_torch.ops.binning import _tile_grid, pair_keys
    from legslam_torch.ops.cuda import sort as cs
    from legslam_torch.ops.projection import preprocess
    from legslam_torch.utils.transforms import normalize_quat
    st, view, _ = smoke.make_scene(dev, 1200, 680, 200_000, 1 << 18, seed=0)
    pre = preprocess(st.params.xyz, st.scales(),
                     normalize_quat(st.params.rotation), st.valid,
                     view.world_view, view.full_proj, view.width, view.height,
                     view.focal_x, view.focal_y, view.tan_fovx,
                     view.tan_fovy, 1.0)
    cfg = smoke.make_cfg(1 << 20, "bfloat16")
    _, keys, _, _ = pair_keys(pre, view.width, view.height, cfg,
                              opacity=st.opacities())
    ntx, nty = _tile_grid(view.width, view.height, cfg)
    key_bits = (ntx * nty * pre.depth.shape[0]).bit_length()
    bits = cs.argsort_bits(pre.depth, pre.mask)
    g = torch.Generator(device=dev).manual_seed(0)
    n = keys.shape[0]
    rk = torch.randint(-(1 << 15), 1 << 15, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    rv = torch.randint(0, 16, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    return keys, key_bits, bits, rk, rv


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sort: no CUDA device", file=sys.stderr)
        return 2
    from legslam_torch.ops.cuda import sort as cs
    dev = torch.device("cuda")
    card = smoke.card_line()
    keys, key_bits, bits, rk, rv = inputs(dev)
    iota = torch.arange(bits.shape[0], dtype=torch.int32, device=dev)
    ok = (torch.equal(cs.sort_keys(keys, key_bits), cs.sort_keys_plain(keys))
          and torch.equal(cs.argsort_order(bits),
                          cs.sort_kv_plain(bits, iota)[1])
          and all(torch.equal(a, b) for a, b in
                  zip(cs.sort_kv(rk, rv), cs.sort_kv_plain(rk, rv))))
    if not ok:
        print("profile_sort: a kernel differs from its plain version",
              file=sys.stderr)
        return 1
    calls = {"sort_keys": (lambda: cs.sort_keys(keys, key_bits), 20),
             "argsort": (lambda: cs.argsort_order(bits), 50),
             "sort_kv": (lambda: cs.sort_kv(rk, rv), 10)}
    lib_calls = {"torch.sort": (lambda: torch.sort(keys), 20),
                 "torch.sort(stable)": (
                     lambda: torch.sort(bits, stable=True), 50)}
    times = {k: [] for k in {**calls, **lib_calls}}
    with smoke.ClockSampler() as clk:
        for group in (calls, lib_calls, lib_calls, calls):
            for k, (fn, reps) in group.items():
                times[k].append(smoke.event_ms(fn, reps))
    # host time a call takes to enqueue (wrapper, allocations, launches),
    # without synchronising: above the device time, the host bounds it
    host_us = {}
    for k, (fn, reps) in {**calls, **lib_calls}.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us[k] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    n = keys.shape[0]
    share = float((keys == keys.max()).float().mean())
    print(f"[inputs] {n} pair keys ({share:.1%} sentinels, key_bits "
          f"{key_bits}), {bits.shape[0]} depth keys, {n} random pairs "
          f"[{card}]")
    print("[times] ms, bit-exact: " + "; ".join(
        f"{k} {statistics.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
        for k, v in times.items()) + f" [{card}]")
    print(f"[host] enqueue us per call: "
          f"{ {k: round(v, 1) for k, v in host_us.items()} } [{card}]")
    print(f"[clocks] {clk.summary()} [{card}]")

    for k in ("sort_keys", "argsort", "torch.sort", "torch.sort(stable)"):
        fn, _ = {**calls, **lib_calls}[k]
        fn()
        torch.cuda.synchronize()
        reps = 10
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = smoke_self_us(e)
            if us > 0:
                rows.append((us / reps, e.count // reps, e.key[:60]))
        rows.sort(reverse=True)
        print(f"[profile] {k}, per call: " + "; ".join(
            f"{name} x{cnt} {us:.1f} us" for us, cnt, name in rows) +
            f" [{card}]")
    return 0


def smoke_self_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


if __name__ == "__main__":
    sys.exit(main())
