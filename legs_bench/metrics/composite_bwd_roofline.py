"""The backward compositing kernel's share of its roofline
(csrc/composite_bwd.cu), read as composite_fwd_roofline reads the
forward's, with the bound of the backward. Moves frames_per_s."""
KERNEL = "composite_bwd_kernel"
LAUNCHES = "composite_bwd"


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
