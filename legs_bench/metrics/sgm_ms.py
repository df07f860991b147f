"""Mean host-clock ms of one semi-global matching (legslam_torch/ops/
stereo.py sgm_disparity, run once a keyframe by the stereo trajectory
frontend): the benchmark's span around each call, synchronised at both
ends, in the traced run's window of spans. Moves frame_ms_p90."""


def read(data):
    ms = data.get("spans", {}).get("sgm")
    return sum(ms) / len(ms) if ms else None
