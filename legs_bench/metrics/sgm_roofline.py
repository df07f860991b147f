"""Semi-global matching's share of its roofline: the least time of the
SGMs of the profiled window (legs_bench/sgm_bound.py at the cell's
width, height and disparities: the larger of bytes / 3.35 TB/s and f32
ops / 67 TFLOP/s, whatever implements them) over the device time of the
operations launched inside them (as sgm_launches counts them). Moves
frame_ms_p90."""


def read(data):
    s = data.get("sgm")
    if not s or not s["calls"] or s["device_ms"] <= 0:
        return None
    return 100.0 * s["bound"]["bound_ms"] * s["calls"] / s["device_ms"]
