"""The traced run's instruments, all from the benchmark's own files.

  - Spans: marks around the calls into each layer. While the profiler
    traces they are marks in its trace alone, with no synchronise, so an
    idle gap of the device can be named by what the host was doing and
    the device's timeline is that of the untraced loop; in a window of
    their own without the profiler they are host-clock spans with a
    synchronise at both ends.
  - Launch samples: the arguments of a seeded sample of the compositing
    kernels' launches, and the count of all launches, taken by standing in
    for the kernel wrappers the way a test double does.
  - Device: torch.profiler over the traced window, reduced to the union
    of the device's busy intervals, the time by kernel name, each
    kernel's intervals in order and the longest idle gaps.
"""
from __future__ import annotations

import contextlib
import random
import time
from collections import defaultdict

import torch


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Named marks in the profiler's trace; while `synced`, also host-clock
    spans (ms) with a synchronise at both ends."""

    def __init__(self, dev, synced: bool = True):
        self.dev, self.synced = dev, synced
        self.ms = defaultdict(list)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace obj.attr (a bound method) by a spanned call."""
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        setattr(obj, attr, spanned)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.synced:
            with torch.profiler.record_function("legs_bench." + name):
                yield
            return
        sync(self.dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("legs_bench." + name):
            yield
            sync(self.dev)
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


class LaunchSampler:
    """Stands in for a kernel wrapper of legslam_torch.ops.cuda.composite_bwd
    while the traced window runs: counts its calls and keeps the arguments
    of about `k` of them, every `stride`-th from a seeded offset."""

    def __init__(self, module, attr: str, seed: int, k: int, stride: int):
        self.module, self.attr = module, attr
        self.real = getattr(module, attr)
        self.k, self.stride = k, stride
        self.offset = random.Random(seed).randrange(stride)
        self.calls = 0
        self.samples = []       # (call index, args)

    # the wrappers count their launches on the module attribute, which is
    # this object while it stands in: the count goes on to the real one
    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.real.launches = value

    def __call__(self, *args):
        i = self.calls
        self.calls += 1
        if len(self.samples) < self.k and i % self.stride == self.offset:
            self.samples.append((i, args))
        return self.real(*args)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)
        return False


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _events(prof):
    """(name, is_device, start_us, end_us) of every event in the trace."""
    out = []
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            dev_type = str(e.device_type())
            is_dev = "CUDA" in dev_type or "GPU" in dev_type
            start = e.start_ns() / 1e3
            out.append((e.name(), is_dev, start, start + e.duration_ns()
                        / 1e3))
        return out
    for e in prof.events():
        is_dev = "CUDA" in str(e.device_type)
        out.append((e.name, is_dev, e.time_range.start, e.time_range.end))
    return out


def reduce_trace(prof, window_s: float) -> dict:
    """The device's busy seconds (the union of its operations' intervals),
    seconds by operation name, each operation's intervals in start order,
    and the ten longest idle gaps named by the innermost benchmark span
    the host was in when the gap opened."""
    ev = _events(prof)
    # the spans' marks are mirrored on the device's timeline as
    # annotations: they are no device operations
    dev = sorted((s, e, n) for n, is_dev, s, e in ev
                 if is_dev and e > s and not n.startswith("legs_bench."))
    spans = sorted((s, e, n) for n, is_dev, s, e in ev
                   if not is_dev and n.startswith("legs_bench."))
    busy = 0.0
    gaps = []
    by_name = defaultdict(float)
    intervals = defaultdict(list)
    cur_s = cur_e = None
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e6
        intervals[n].append((s, e))
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:10]:
        # the innermost span holding the gap's start: the last to begin
        inner = [(s, n) for s, e, n in spans if s <= at <= e]
        label = max(inner)[1].replace("legs_bench.", "") if inner else \
            "outside the benchmark's spans"
        named.append([label, length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e6, window_s=window_s,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=named, intervals=dict(intervals))
