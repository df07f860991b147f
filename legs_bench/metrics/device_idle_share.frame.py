"""Share of the traced frame window in which no operation ran on the
device: 100 x (1 - busy / window), busy being the union of the device's
operation intervals in torch.profiler's trace. Moves frames_per_s."""


def read(data):
    if data.get("kind") != "frame" or data["device"]["window_s"] <= 0:
        return None
    dev = data["device"]
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
