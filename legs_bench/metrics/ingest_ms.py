"""Mean host-clock ms of the frontend and the keyframe ingest on a
keyframe frame: the spans around slam/trajectory.py's track and
GaussianMapper.drain_operations, synchronised at both ends, summed for
each keyframe frame of the traced window. Moves frame_ms_p90."""


def read(data):
    ms = data.get("ingest_ms")
    return sum(ms) / len(ms) if ms else None
