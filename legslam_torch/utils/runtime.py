"""Runtime helpers: the program's spans, profiling and device-memory
statistics.

Counterpart of legslam_tpu/utils/runtime.py. Two of its functions have no
meaning under PyTorch and are not defined here: `enable_compilation_cache`
(PyTorch runs eagerly; the CUDA kernels are built once into
build/legslam_torch/ by legslam_torch._build) and `force_cpu` (the port
picks a device per call: every entry point takes `device=`).

Spans. The program marks its layers with `span(name, **attrs)`: the
frame, the encoder, tracking, the mapper's drain and ingest, each mapping
iteration and the phases of its step, the server's requests. The tracer is
off unless `tracing(True)` turned it on; then a span keeps its name, ids,
thread, host-clock start and end and the attributes the host already holds,
in memory, until `trace_export()` hands them over on torch.profiler's
clock. A span never synchronises the device: it times what the host does,
and a profiler trace puts the device's work down to it (a kernel to the
span its launch lies in).
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager

import torch

_on = False
_kept: list[tuple] = []
# (time_ns, perf_counter_ns) when tracing was turned on: the spans run on
# perf_counter and are handed over on the wall clock, torch.profiler's
_anchor = (0, 0)
_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    """What `span` returns while the tracer is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "sid", "parent", "root", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        self.sid = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root = top.sid, top.root
        else:
            self.parent, self.root = None, self.sid
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        _kept.append((self.name, self.sid, self.parent, self.root,
                      _local.tid, self.t0, t1, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a reply's status)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one call into a layer, kept while the
    tracer is on. Spans nest per thread: a span opened with none open on
    its thread is a root (a frame, a request), and every span under it
    carries its root's id. While the tracer is off this is one check and
    a shared object that does nothing."""
    if not _on:
        return _NO_SPAN
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: every call of the function is a span of `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def tracing(on: bool) -> None:
    """Turn the tracer on (a fresh trace: spans kept before are dropped)
    or off (spans already kept stay for trace_export)."""
    global _on, _anchor
    if on and not _on:
        _kept.clear()
        _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = bool(on)


def trace_export() -> list[dict]:
    """The spans ended since tracing was turned on or since the last
    export, as dicts in the order they ended, and forgets them. Times are
    ns on torch.profiler's clock (the wall clock, `start_ns()` of its
    events): `start_ns`, `end_ns`."""
    wall, pc = _anchor
    n = len(_kept)      # spans other threads end meanwhile stay kept
    done = _kept[:n]
    del _kept[:n]
    return [dict(name=name, id=sid, parent=parent, root=root, thread=tid,
                 start_ns=wall + (t0 - pc), end_ns=wall + (t1 - pc),
                 attrs=attrs)
            for name, sid, parent, root, tid, t0, t1, attrs in done]


@contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present), with the tracer on, written as a Chrome trace to
    <log_dir>/trace.json (view in Perfetto or chrome://tracing): the
    reference's chrono probes (SURVEY.md §5). The program's spans are a
    process of their own in it, "legslam_torch spans", one row a thread,
    on the profiler's clock above its CPU and CUDA rows."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    was_on = _on
    tracing(True)
    try:
        with profile(activities=acts) as prof:
            yield log_dir
    finally:
        tracing(was_on)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, trace_export())


# a pid no process has (Linux's pid_max is at most 2^22) and no device row
# of the profiler's trace uses
_SPAN_PID = (1 << 22) + 1


def _add_span_track(path: str, spans: list[dict]) -> None:
    """Append `spans` to the Chrome trace at `path` as complete events of
    the span process, on the trace's own time base (µs after
    baseTimeNanoseconds)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    ev = trace["traceEvents"]
    ev.append(dict(ph="M", name="process_name", pid=_SPAN_PID, tid=0,
                   args=dict(name="legslam_torch spans")))
    ev.append(dict(ph="M", name="process_sort_index", pid=_SPAN_PID, tid=0,
                   args=dict(sort_index=-1)))
    for s in spans:
        ev.append(dict(ph="X", cat="legslam_span", name=s["name"],
                       pid=_SPAN_PID, tid=s["thread"],
                       ts=(s["start_ns"] - base) / 1e3,
                       dur=(s["end_ns"] - s["start_ns"]) / 1e3,
                       args=dict(s["attrs"], id=s["id"], parent=s["parent"],
                                 root=s["root"])))
    with open(path, "w") as f:
        json.dump(trace, f)


def device_memory_stats() -> dict:
    """{device name: {bytes_in_use, peak_bytes_in_use, bytes_reserved}}
    of every CUDA device, from PyTorch's caching allocator (the c10
    CUDACachingAllocator statistics of examples/replica_rgbd.cpp:280-294);
    empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i} {torch.cuda.get_device_name(i)}"] = dict(
            bytes_in_use=torch.cuda.memory_allocated(i),
            peak_bytes_in_use=torch.cuda.max_memory_allocated(i),
            bytes_reserved=torch.cuda.memory_reserved(i))
    return out


def save_peak_memory(path: str, device: torch.device) -> None:
    """The reference's GpuPeakUsageMB.txt (examples/replica_rgbd.cpp:
    280-294): one 'device peak_mb in_use_mb' line from PyTorch's caching
    allocator."""
    with open(path, "w") as f:
        if device.type != "cuda":
            f.write(f"{device} peak_mb=not measured\n")
            return
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
        cur = torch.cuda.memory_allocated(device) / 2 ** 20
        f.write(f"{torch.cuda.get_device_name(device)} peak_mb={peak:.1f} "
                f"in_use_mb={cur:.1f}\n")
