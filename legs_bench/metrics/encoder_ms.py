"""Mean host-clock ms of the encoder (models/encoder.py, dinov2.py, pca.py)
a frame: the span around create_language_features, synchronised at both
ends. Moves frames_per_s."""


def read(data):
    ms = data.get("spans", {}).get("encoder")
    return sum(ms) / len(ms) if ms else None
