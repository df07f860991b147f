"""The program's own spans (legslam_torch/utils/runtime.py) in a cell's
run, and a profiler trace put down to them, on the card.

    python3 legs_bench/program_spans.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --tracer <0|1> [--trace 1]

Runs the cell once a seed in one process, as legs_bench/calibrate.py
does, through its generator and comparison, with the program's tracer
on (`--tracer 1`) or off from the start of the measured window to the
end of the run. It prints a JSON line a seed: the end-to-end metrics, `correct`,
and with the tracer on what the spans give:

  - `--trace 0` (the cell's measured window, no profiler, nothing
    synchronised but each frame's end): each span name's count, host ms
    and self ms, `step_host_ms` (mean `map_iter` span), `binning_fresh_
    share` (100 x `map.binning` spans / `map_iter` spans) and
    `query_server_ms` (mean self time of `request`: the span less its
    `query.embed` and `query.search` children);
  - `--trace 1` (the cell's profiled window): `attribute` of the
    profiler's events to the spans: each kernel launch (matched to its
    device operation by the trace's correlation id) and each idle gap of
    the device put down to the innermost span that holds it in time, on
    any thread; `step_launches` and `step_device_ms` (device operations
    launched inside a `map_iter` span, and their device time, a
    `map_iter`), `idle_by_span` and the share of the idle time inside
    `frame` spans that falls inside one of their descendants.

`--ab <k>` (a loop cell, `--trace 0`) turns the tracer off and on in blocks
of k frames of the window instead, in the order off, on, on, off (so a
store that grows through the window weighs on both alike), and gives each
frame's ms and the garbage collections it ran: the tracer's cost on the
same store, process and card. `--ab-iters <n>` does the same for n
mapping iterations, one a block, run as the window opens. `--costs`
prints the tracer's own cost on this host: a span call with the tracer
off and on, and the host's time a launch of a small elementwise kernel.
The benchmark's own runs never import this file.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
import timeit
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

from legs_bench import harness, run, tracing  # noqa: E402

MEMCPY = ("Memcpy", "Memset")


def events_of(prof) -> list[dict]:
    """Each event of a torch.profiler trace: name, whether it ran on the
    device, start and end (ns, the wall clock), correlation id, and
    whether it is a record_function mark mirrored onto the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev_type = str(e.device_type())
        is_dev = "CUDA" in dev_type or "GPU" in dev_type
        mark = getattr(e, "is_user_annotation", None)
        start = int(e.start_ns())
        out.append(dict(name=e.name(), device=is_dev, start_ns=start,
                        end_ns=start + int(e.duration_ns()),
                        corr=int(e.correlation_id()),
                        mark=bool(mark()) if mark else False))
    return out


def innermost_segments(spans: list[dict]) -> list[tuple]:
    """The timeline cut where any span starts or ends: (start, end, span
    id or None) pieces, each labelled with the innermost span open over
    it, on any thread: the open span that started last."""
    cuts = sorted({s["start_ns"] for s in spans} |
                  {s["end_ns"] for s in spans})
    by_start = sorted(spans, key=lambda s: s["start_ns"])
    segs, open_, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(by_start) and by_start[i]["start_ns"] <= a:
            open_.append(by_start[i])
            i += 1
        open_ = [s for s in open_ if s["end_ns"] > a]
        inner = max(open_, key=lambda s: (s["start_ns"], -s["end_ns"]),
                    default=None)
        segs.append((a, b, None if inner is None else inner["id"]))
    return segs


def attribute(events: list[dict], spans: list[dict], w0: int | None = None,
              w1: int | None = None) -> dict:
    """Launches, device time and idle time put down to program spans.

    A device operation (kernel, copy or fill; not a mirrored mark) counts
    as one launch of the span whose time holds the CUDA API call with the
    same correlation id (the host's other events number theirs apart),
    with the operation's device time. An idle gap of the device (between
    two of its operations, inside [w0, w1] when given) is cut where spans
    start and end, each piece going to the innermost span open over it.
    Returns, for each span id, {"launches", "kernels", "device_ns",
    "idle_ns"}; the launches and idle time no span holds
    (`unattributed`); and the ten longest gaps, each as its length and
    {span id or None: ns of it}."""
    dev = sorted((e for e in events if e["device"] and not e["mark"] and
                  not e["name"].startswith("legs_bench.") and
                  e["end_ns"] > e["start_ns"]),
                 key=lambda e: e["start_ns"])
    host = {e["corr"]: e for e in events
            if not e["device"] and e["name"].startswith("cu")}
    segs = innermost_segments(spans)
    starts = [s[0] for s in segs]

    def holder(t):
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t >= segs[k][1]:
            return None
        return segs[k][2]
    per = defaultdict(lambda: dict(launches=0, kernels=0, device_ns=0,
                                   idle_ns=0))
    for e in dev:
        launch = host.get(e["corr"])
        sid = None if launch is None else holder(launch["start_ns"])
        p = per[sid]
        p["launches"] += 1
        p["kernels"] += not e["name"].startswith(MEMCPY)
        p["device_ns"] += e["end_ns"] - e["start_ns"]
    gaps, cur = [], None
    for e in dev:
        if cur is not None and e["start_ns"] > cur:
            gaps.append((cur, e["start_ns"]))
        cur = e["end_ns"] if cur is None else max(cur, e["end_ns"])
    longest = []
    for a, b in gaps:
        a = a if w0 is None else max(a, w0)
        b = b if w1 is None else min(b, w1)
        if b <= a:
            continue
        pieces = defaultdict(int)
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        t = a
        while t < b:
            if k >= len(segs) or t < segs[k][0]:
                nxt = min(segs[k][0] if k < len(segs) else b, b)
                pieces[None] += nxt - t
                t = nxt
                continue
            end = min(segs[k][1], b)
            if end > t:
                pieces[segs[k][2]] += end - t
                t = end
            k += 1
        for sid, ns in pieces.items():
            per[sid]["idle_ns"] += ns
        longest.append((b - a, dict(pieces)))
    longest.sort(key=lambda g: -g[0])
    out = dict(per)
    unattributed = out.pop(None, dict(launches=0, kernels=0, device_ns=0,
                                      idle_ns=0))
    return dict(spans=out, unattributed=unattributed,
                longest_gaps=longest[:10])


def ancestry(spans: list[dict]):
    """name-of(id) and the names of a span id and its ancestors."""
    by_id = {s["id"]: s for s in spans}

    def chain(sid):
        names = []
        while sid is not None and sid in by_id:
            names.append(by_id[sid]["name"])
            sid = by_id[sid]["parent"]
        return names
    return by_id, chain


def self_ns(spans: list[dict]) -> dict:
    """Each span id's duration less the part its children cover (they
    nest on one thread, so less their durations)."""
    own = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans}
    for s in spans:
        if s["parent"] in own:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return own


def host_summary(spans: list[dict]) -> dict:
    """By span name: count, host ms and self ms (sums), and the would-be
    metrics of the program window."""
    own = self_ns(spans)
    by = defaultdict(lambda: dict(n=0, host_ms=0.0, self_ms=0.0))
    for s in spans:
        b = by[s["name"]]
        b["n"] += 1
        b["host_ms"] += (s["end_ns"] - s["start_ns"]) / 1e6
        b["self_ms"] += own[s["id"]] / 1e6
    out = dict(by_name=dict(by))
    iters = by.get("map_iter")
    if iters:
        out["step_host_ms"] = iters["host_ms"] / iters["n"]
        out["binning_fresh_share"] = 100.0 * by.get(
            "map.binning", dict(n=0))["n"] / iters["n"]
        # each phase of the iteration: mean host self ms an iteration
        by_id, chain = ancestry(spans)
        phase = defaultdict(float)
        for s in spans:
            if "map_iter" in chain(s["id"]):
                phase[s["name"]] += own[s["id"]] / 1e6 / iters["n"]
        out["step_phase_self_ms"] = dict(phase)
    req = [s for s in spans if s["name"] == "request"]
    if req:
        kids = defaultdict(int)
        for s in spans:
            if s["name"] in ("query.embed", "query.search"):
                kids[s["parent"]] += s["end_ns"] - s["start_ns"]
        out["query_server_ms"] = statistics.fmean(
            (r["end_ns"] - r["start_ns"] - kids[r["id"]]) / 1e6
            for r in req)
    return out


def trace_summary(att: dict, spans: list[dict]) -> dict:
    """The attribution by span name, the metrics of the profiled window,
    the ten names with the most idle time, and the share of the idle time
    inside frame spans that their descendants hold."""
    by_id, chain = ancestry(spans)
    by = defaultdict(lambda: dict(launches=0, kernels=0, device_ms=0.0,
                                  idle_ms=0.0))
    step = dict(launches=0, kernels=0, device_ns=0)
    phase = defaultdict(lambda: dict(launches=0, device_ms=0.0))
    frame_idle = inner_idle = 0
    for sid, p in att["spans"].items():
        names = chain(sid)
        b = by[names[0]]
        b["launches"] += p["launches"]
        b["kernels"] += p["kernels"]
        b["device_ms"] += p["device_ns"] / 1e6
        b["idle_ms"] += p["idle_ns"] / 1e6
        if "map_iter" in names:
            for k in step:
                step[k] += p[k]
            phase[names[0]]["launches"] += p["launches"]
            phase[names[0]]["device_ms"] += p["device_ns"] / 1e6
        if "frame" in names:
            frame_idle += p["idle_ns"]
            if names[0] != "frame":
                inner_idle += p["idle_ns"]
    n_iter = sum(1 for s in spans if s["name"] == "map_iter")
    out = dict(by_name=dict(by), unattributed=att["unattributed"],
               idle_by_span=sorted(([n, b["idle_ms"] / 1e3]
                                    for n, b in by.items()),
                                   key=lambda kv: -kv[1])[:10],
               # each long gap: its seconds, and the spans (innermost
               # last) that hold it, with the share each holds
               longest_gaps=[[ns / 1e9, sorted(
                   (["<".join(chain(sid)) or "no span", part / ns]
                    for sid, part in pieces.items()),
                   key=lambda kv: -kv[1])]
                   for ns, pieces in att["longest_gaps"]])
    if frame_idle:
        out["frame_idle_in_descendants"] = inner_idle / frame_idle
    if n_iter:
        out["map_iter_spans"] = n_iter
        out["step_launches"] = step["launches"] / n_iter
        out["step_kernels"] = step["kernels"] / n_iter
        out["step_device_ms"] = step["device_ns"] / 1e6 / n_iter
        out["step_phase"] = {k: dict(launches=v["launches"] / n_iter,
                                     device_ms=v["device_ms"] / n_iter)
                             for k, v in phase.items()}
    return out


class Probe:
    """Stands in for the benchmark's tracing.Spans and reduce_trace while
    a cell runs: the generator makes its Spans as its window opens, which
    turns the program's tracer on here, and hands its profiler to
    reduce_trace as the profiled window closes, which puts the trace down
    to the spans kept since."""

    def __init__(self, tracer: bool, ab: int = 0, ab_iters: int = 0):
        from legslam_torch.apps import replica_rgbd
        self.tracer, self.ab, self.ab_iters = tracer, ab or bool(ab_iters), \
            ab_iters
        self.real_spans = tracing.Spans
        self.real_reduce = tracing.reduce_trace
        self.app, self.real_frame = replica_rgbd, replica_rgbd.process_frame
        self.traced = None
        self.spans = []
        self.window = False
        self.ab_ms = []     # (tracer on, frame ms, collections) a frame

    def __enter__(self):
        import torch
        from legslam_torch.utils import runtime
        probe = self
        sync = torch.cuda.synchronize if torch.cuda.is_available() else \
            (lambda: None)

        def ab_call(fn, *a, **k):
            """fn, timed, the tracer on in the middle two of every four
            blocks."""
            on = len(probe.ab_ms) // probe.ab % 4 in (1, 2)
            runtime.tracing(on)
            sync()
            n0 = sum(g["collections"] for g in gc.get_stats())
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            probe.ab_ms.append((on, (time.perf_counter() - t0) * 1e3,
                                sum(g["collections"] for g in
                                    gc.get_stats()) - n0))
            runtime.tracing(False)
            runtime.trace_export()
            return out

        class Spans(self.real_spans):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                if probe.ab_iters and not probe.window:
                    # before the generator's recorders start: the window's
                    # checks see these iterations as set-up
                    for _ in range(probe.ab_iters):
                        ab_call(probe.mapper.train_iteration)
                probe.window = True
                runtime.tracing(probe.tracer and not probe.ab)

        def ab_frame(frame, frontend, mapper, *a, **k):
            probe.mapper = mapper
            if not probe.window or probe.ab_iters:
                return probe.real_frame(frame, frontend, mapper, *a, **k)
            return ab_call(probe.real_frame, frame, frontend, mapper, *a,
                           **k)
        if self.ab:
            self.app.process_frame = ab_frame

        def reduce_trace(prof, window_s):
            spans = in_roots(runtime.trace_export())
            ev = events_of(prof)
            host = [e for e in ev if not e["device"]]
            w0 = min((e["start_ns"] for e in host), default=None)
            w1 = max((e["end_ns"] for e in host), default=None)
            probe.traced = dict(
                trace_summary(attribute(ev, spans, w0, w1), spans),
                host=host_summary(spans))
            return probe.real_reduce(prof, window_s)
        tracing.Spans, tracing.reduce_trace = Spans, reduce_trace
        return self

    def __exit__(self, *exc):
        from legslam_torch.utils import runtime
        tracing.Spans = self.real_spans
        tracing.reduce_trace = self.real_reduce
        self.app.process_frame = self.real_frame
        runtime.tracing(False)
        self.spans = in_roots(runtime.trace_export())
        return False


def in_roots(spans: list[dict]) -> list[dict]:
    """The spans of frames and requests: not those of the comparison that
    follows the window."""
    roots = {s["id"] for s in spans if s["parent"] is None and
             s["name"] in ("frame", "request")}
    return [s for s in spans if s["root"] in roots]


def ab_summary(ab_ms: list, k: int) -> dict:
    """Frame ms with the tracer on and off, and the median over the
    window's (off, on, on, off) runs of blocks of the ratio of the on
    blocks' mean frame ms to the off blocks'."""
    on = [ms for o, ms, _ in ab_ms if o]
    off = [ms for o, ms, _ in ab_ms if not o]
    quads = [ab_ms[i:i + 4 * k] for i in range(0, len(ab_ms) - 4 * k + 1,
                                                4 * k)]
    ratios = [statistics.fmean(ms for o, ms, _ in q if o) /
              statistics.fmean(ms for o, ms, _ in q if not o) for q in quads]
    out = dict(block=k, frames_on=len(on), frames_off=len(off),
               quads=len(ratios),
               collections_on=sum(c for o, _, c in ab_ms if o),
               collections_off=sum(c for o, _, c in ab_ms if not o),
               frames=[[int(o), ms, c] for o, ms, c in ab_ms])
    if ratios:
        out.update(mean_on=statistics.fmean(on),
                   mean_off=statistics.fmean(off),
                   median_on=statistics.median(on),
                   median_off=statistics.median(off),
                   ratio_median=statistics.median(ratios))
    return out


def run_cell(args, spec, dev, limits, tracer: bool, ab: int = 0,
             ab_iters: int = 0) -> dict:
    """One run of the cell with the probe in place: what it prints."""
    with Probe(tracer, ab, ab_iters) as probe:
        res = run.execute(args, spec, dev, limits, time.time())
    checks = res["checks"]
    out = dict(seed=args.seed, trace=args.trace, tracer=tracer,
               e2e=res["e2e"], info=res["info"],
               correct=all(c["value"] <= c["limit"]
                           for c in checks.values()))
    if ab or ab_iters:
        out["ab"] = ab_summary(probe.ab_ms, probe.ab)
    elif args.trace:
        out["profiled"] = probe.traced
    elif tracer:
        out["window"] = host_summary(probe.spans)
    return out


def costs(dev) -> dict:
    """µs of a span call with the tracer off and on, and of one launch of
    a small elementwise kernel as the host issues it."""
    import torch
    from legslam_torch.utils import runtime
    n = 1000

    def spans():
        for _ in range(n):
            with runtime.span("x"):
                pass
        runtime.trace_export()      # as a program window hands them over
    runtime.tracing(False)
    off = min(timeit.repeat(spans, number=200, repeat=5)) / n / 200 * 1e6
    runtime.tracing(True)
    on = min(timeit.repeat(spans, number=200, repeat=5)) / n / 200 * 1e6
    runtime.tracing(False)
    x = torch.zeros(1, device=dev)
    for _ in range(1000):
        x.add_(1.0)
    torch.cuda.synchronize(dev)
    k = 20_000
    t0 = time.perf_counter()
    for _ in range(k):
        x.add_(1.0)
    host = (time.perf_counter() - t0) / k * 1e6
    torch.cuda.synchronize(dev)

    def among_launches():
        """µs a round of two nested spans around ten launches."""
        t0 = time.perf_counter()
        for _ in range(2000):
            with runtime.span("a"):
                with runtime.span("b"):
                    for _ in range(10):
                        x.add_(1.0)
        torch.cuda.synchronize(dev)
        runtime.trace_export()
        return (time.perf_counter() - t0) / 2000 * 1e6
    rounds = {False: [], True: []}
    for _ in range(6):
        for state in (False, True, True, False):
            runtime.tracing(state)
            rounds[state].append(among_launches())
    runtime.tracing(False)
    return dict(span_off_us=off, span_on_us=on, launch_host_us=host,
                round_off_us=statistics.median(rounds[False]),
                round_on_us=statistics.median(rounds[True]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", default=[])
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--ab", type=int, default=0)
    p.add_argument("--ab-iters", type=int, default=0)
    p.add_argument("--costs", action="store_true")
    a = p.parse_args(argv)
    run.cache_dirs(run.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    from legs_bench import frozen
    dev = torch.device("cuda", 0)
    print(f"card: {frozen.card_line()}", file=sys.stderr)
    if a.costs:
        print(json.dumps(costs(dev)), flush=True)
    if not a.workload:
        return 0
    bench = harness.load_bench(run.ROOT)
    spec = harness.cell_spec(run.ROOT, bench, a.workload)
    limits = run.limits_of(a.workload)
    for seed in a.seeds:
        args = argparse.Namespace(seed=seed, seconds=a.seconds,
                                  trace=a.trace, workload=a.workload)
        print(json.dumps(run_cell(args, spec, dev, limits, bool(a.tracer),
                                  a.ab, a.ab_iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
