"""legs_bench/program_spans.py: a fabricated trace put down to fabricated
program spans, and the tiny cells run with the program's tracer on."""
from __future__ import annotations

import argparse

import pytest
import torch

from conftest import ROOT, tiny
from legs_bench import harness, program_spans as PS, run, tracing

MS = 1_000_000      # ns


def span(sid, name, a, b, parent=None, root=None, thread=1):
    return dict(id=sid, name=name, start_ns=a * MS, end_ns=b * MS,
                parent=parent, root=root or sid, thread=thread, attrs={})


def launch(corr, t, kernel=None, name="k"):
    """A runtime call at t (ms) and the device operation it launched."""
    out = [dict(name="cudaLaunchKernel", device=False, start_ns=t * MS,
                end_ns=t * MS + 5_000, corr=corr, mark=False)]
    if kernel:
        out.append(dict(name=name, device=True, start_ns=kernel[0] * MS,
                        end_ns=kernel[1] * MS, corr=corr, mark=False))
    return out


SPANS = [span(1, "frame", 0, 100), span(2, "map_iter", 10, 60, 1, 1),
         span(3, "step.render", 20, 40, 2, 1),
         span(4, "encoder", 70, 90, 1, 1)]
EVENTS = (launch(1, 25, (30, 35)) + launch(2, 15, (50, 52), "Memcpy HtoD")
          + launch(3, 75, (80, 85)) + launch(4, 150, (150, 160))
          # a record_function mark mirrored onto the device: no operation
          + [dict(name="mark", device=True, start_ns=0, end_ns=200 * MS,
                  corr=0, mark=True),
             # an operator event numbers its own ids: no launch
             dict(name="aten::mul", device=False, start_ns=150 * MS,
                  end_ns=151 * MS, corr=1, mark=False)])


def test_launches_and_idle_go_to_the_innermost_span():
    att = PS.attribute(EVENTS, SPANS)
    s = att["spans"]
    # a kernel launched in a nested span goes to the inner span
    assert s[3] == dict(launches=1, kernels=1, device_ns=5 * MS,
                        idle_ns=5 * MS)
    # the copy launched in map_iter's own time; the gaps 40-50 and 52-60
    assert s[2] == dict(launches=1, kernels=0, device_ns=2 * MS,
                        idle_ns=18 * MS)
    assert s[4]["launches"] == 1 and s[4]["idle_ns"] == 15 * MS
    assert s[1] == dict(launches=0, kernels=0, device_ns=0, idle_ns=20 * MS)
    # a launch and a gap no span holds are unattributed
    assert att["unattributed"] == dict(launches=1, kernels=1,
                                       device_ns=10 * MS, idle_ns=50 * MS)
    assert att["longest_gaps"] == [
        (65 * MS, {4: 5 * MS, 1: 10 * MS, None: 50 * MS}),
        (28 * MS, {2: 8 * MS, 1: 10 * MS, 4: 10 * MS}),
        (15 * MS, {3: 5 * MS, 2: 10 * MS})]


def test_a_window_clips_the_gaps():
    att = PS.attribute(EVENTS, SPANS, w0=45 * MS, w1=95 * MS)
    idle = {k: v["idle_ns"] // MS for k, v in att["spans"].items()}
    assert idle == {2: 13, 3: 0, 4: 15, 1: 15}
    assert att["unattributed"]["idle_ns"] == 0


def test_spans_on_other_threads_hold_launches_in_time():
    """Autograd's backward thread launches while the caller's
    step.backward span is open: the launch goes to that span."""
    spans = SPANS + [span(5, "step.backward", 42, 58, 2, 1)]
    att = PS.attribute(launch(9, 44, (45, 46)), spans)
    assert att["spans"][5]["launches"] == 1


def test_summaries():
    att = PS.attribute(EVENTS, SPANS)
    t = PS.trace_summary(att, SPANS)
    assert t["map_iter_spans"] == 1
    assert t["step_launches"] == 2 and t["step_kernels"] == 1
    assert t["step_device_ms"] == pytest.approx(7.0)
    assert t["frame_idle_in_descendants"] == pytest.approx(38 / 58)
    assert t["idle_by_span"][0] == ["frame", pytest.approx(0.020)]
    assert t["longest_gaps"][0] == [0.065, [
        ["no span", 50 / 65], ["frame", 10 / 65], ["encoder<frame", 5 / 65]]]
    assert t["step_phase"]["step.render"] == dict(launches=1,
                                                   device_ms=5.0)
    h = PS.host_summary(SPANS)
    assert h["step_host_ms"] == 50.0 and h["binning_fresh_share"] == 0.0
    assert h["by_name"]["map_iter"]["self_ms"] == 30.0
    assert h["step_phase_self_ms"] == {"map_iter": 30.0,
                                       "step.render": 20.0}
    assert "query_server_ms" not in h
    req = [span(1, "request", 0, 100), span(2, "query.embed", 10, 30, 1, 1),
           span(3, "query.search", 40, 90, 1, 1),
           span(4, "search.cluster", 50, 60, 3, 1)]
    assert PS.host_summary(req)["query_server_ms"] == 30.0
    # without their spans the would-be metrics are absent
    none = PS.trace_summary(PS.attribute(EVENTS, []), [])
    assert "step_launches" not in none and none["unattributed"][
        "launches"] == 4
    assert "step_host_ms" not in PS.host_summary([])


def test_ab_summary():
    # (tracer on, frame ms, collections): blocks of 1, off on on off
    ab = [(False, 10.0, 0), (True, 11.0, 1), (True, 13.0, 0),
          (False, 12.0, 2), (False, 20.0, 0), (True, 22.0, 1)]
    out = PS.ab_summary(ab, 1)
    assert (out["frames_on"], out["frames_off"], out["quads"]) == (3, 3, 1)
    assert (out["collections_on"], out["collections_off"]) == (2, 2)
    assert out["mean_off"] == 14.0 and out["median_on"] == 13.0
    assert out["ratio_median"] == 12.0 / 11.0
    assert out["frames"][1] == [1, 11.0, 1]


@pytest.mark.parametrize("cell,trace,ab,ab_iters", [
    ("replica.map15", 0, 0, 0), ("replica.map15", 1, 0, 0),
    ("replica.map15", 0, 2, 0), ("replica.map15", 0, 0, 8),
    ("replica.query", 0, 0, 0)])
def test_tiny_cells_with_the_tracer(cell, trace, ab, ab_iters):
    from legslam_torch.apps import replica_rgbd
    bench = harness.load_bench(ROOT)
    spec = tiny(harness.cell_spec(ROOT, bench, cell))
    args = argparse.Namespace(seed=2 ** 31 + 977, seconds=4.0 if ab else 1.0,
                              trace=trace, workload=cell)
    real = tracing.Spans, tracing.reduce_trace, replica_rgbd.process_frame
    out = PS.run_cell(args, spec, torch.device("cpu"), run.limits_of(cell),
                      tracer=True, ab=ab, ab_iters=ab_iters)
    assert (tracing.Spans, tracing.reduce_trace,
            replica_rgbd.process_frame) == real
    assert out["correct"] is True
    if ab_iters:
        a = out["ab"]
        assert a["frames_on"] == a["frames_off"] == ab_iters // 2
        assert a["quads"] == ab_iters // 4
    elif ab:
        a = out["ab"]
        assert out["info"]["frames"] >= 8 and a["quads"] >= 1
        assert a["frames_on"] + a["frames_off"] == out["info"]["frames"]
        assert a["mean_on"] > 0 and a["ratio_median"] > 0
    elif cell == "replica.query":
        assert 0 < out["window"]["query_server_ms"] < out["e2e"][
            "query_ms_p95"]
    elif trace == 0:
        w = out["window"]
        assert w["step_host_ms"] > 0 and w["binning_fresh_share"] > 0
        assert w["by_name"]["frame"]["n"] == out["info"]["frames"]
    else:
        p = out["profiled"]
        assert p["host"]["step_host_ms"] > 0
        # no device on the CPU: nothing launched, no idle time
        assert p["step_launches"] == 0 and p["unattributed"]["idle_ns"] == 0
