"""The whole frame step's share of the H100's dense bf16 peak (989
TFLOP/s, NVIDIA's data sheet, SXM): the window's counted operations over
(window seconds x peak). Counted are the encoder's from its shapes
(frozen encoder_flops, every frame) and the compositing kernels': the
forward's and the backward's operations of the sampled launches (frozen
bounds, their tiles walked to termination), their mean scaled to the
launches counted in the window. The configuration's arithmetic is float32,
so the share is small by nature: a ceiling that bounds a kernel's gain
once the kernel is gone. Moves frames_per_s."""
from legs_bench.frozen import PEAK_BF16_OPS


def read(data):
    if data.get("kind") != "frame":
        return None
    ops = float(data["encoder_ops"])
    for name in ("composite_fwd", "composite_bwd"):
        rows = data["launch_samples"].get(name, {}).get("rows", [])
        if not rows:
            return None
        mean = sum(r["ops"] for r in rows) / len(rows)
        ops += mean * data["launches"][name]
    return 100.0 * ops / (data["device"]["window_s"] * PEAK_BF16_OPS)
