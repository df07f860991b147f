"""The forward compositing kernel's share of its roofline
(csrc/composite_fwd.cu): for a seeded sample of its launches in the
traced window, the least time from the frozen bounds on each launch's
inputs (the larger of bytes / 3.35 TB/s and f32 ops / 67 TFLOP/s, the
tiles walked to termination) over the launch's device time, read from
torch.profiler's trace by kernel name and launch order. Moves
frames_per_s."""
KERNEL = "composite_fwd_kernel"
LAUNCHES = "composite_fwd"


def read(data):
    s = data.get("launch_samples", {}).get(LAUNCHES)
    if not s or not s["rows"]:
        return None
    iv = [v for n, ivs in data["device"]["intervals"].items()
          if KERNEL in n for v in ivs]
    iv.sort()
    if len(iv) != s["calls"]:
        return None     # the trace does not pair launches with calls
    bound = sum(r["bound_ms"] for r in s["rows"])
    dev_ms = sum((iv[r["call"]][1] - iv[r["call"]][0]) / 1e3
                 for r in s["rows"])
    return 100.0 * bound / dev_ms if dev_ms > 0 else None
