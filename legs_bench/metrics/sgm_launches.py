"""Device operations launched inside one semi-global matching: those of
the profiled window whose launch (the CUDA API call of the same
correlation id) lies inside the benchmark's "sgm" mark, over the SGMs the
window holds whole. Moves frame_ms_p90."""


def read(data):
    s = data.get("sgm")
    if not s or not s["calls"] or not s["launches"]:
        return None
    return s["launches"] / s["calls"]
