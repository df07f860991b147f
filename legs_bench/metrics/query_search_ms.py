"""Mean host-clock ms of the gaussian-space search
(eval_harness/find_objects.find_objects_in_gaussians): the span around
the call, synchronised at both ends. Moves query_ms_p95."""


def read(data):
    ms = data.get("spans", {}).get("query_search")
    return sum(ms) / len(ms) if ms else None
