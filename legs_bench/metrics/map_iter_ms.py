"""Mean host-clock ms of one mapping iteration (mapper/mapper.py
train_iteration -> mapper/train_step.py): the span around each
train_iteration, synchronised at both ends. Moves frames_per_s."""


def read(data):
    ms = data.get("spans", {}).get("map_iter")
    return sum(ms) / len(ms) if ms else None
