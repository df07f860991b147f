"""Mean host-clock ms of the query embedding (models/clip_text.py,
talk2dino.py, pca.py): the span around the server's text-encoder
callable, synchronised at both ends. Moves query_ms_p95."""


def read(data):
    ms = data.get("spans", {}).get("query_embed")
    return sum(ms) / len(ms) if ms else None
