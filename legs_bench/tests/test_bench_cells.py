"""Every cell of BENCHMARK.json rehearsed end to end at a tiny size on
the CPU, through its driver, its comparison and the result line."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, last_line, run_tiny

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, capsys):
    res, args, bench = run_tiny(cell)
    out = last_line(capsys, args, bench, res)
    for k in KEYS:
        assert k in out
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_span_metrics(cell, capsys):
    res, args, bench = run_tiny(cell, trace=1)
    out = last_line(capsys, args, bench, res)
    assert out["correct"] is True, out["checks"]
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the readers of the trace's kernels find nothing
    # and are left out; every span metric of the cell is read
    spans = {m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span" and
             ("workloads" not in m or cell in m["workloads"])}
    names = set(out["metrics"])
    assert spans and spans <= names
    assert not any(n.endswith("_roofline") for n in names)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch
    from legs_bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_seed_above_32_bits_gives_the_same_inputs():
    import torch
    from legs_bench import scene
    intr = dict(width=64, height=36, fx=32.0, fy=32.0, cx=31.5, cy=17.5,
                depth_scale=6553.5)
    seed = 2 ** 31 + 2 ** 30 + 5
    a = scene.make_sequence(seed, 3, intr, torch.device("cpu"))
    b = scene.make_sequence(seed, 3, intr, torch.device("cpu"))
    c = scene.make_sequence(seed + 1, 3, intr, torch.device("cpu"))
    assert (a.color == b.color).all() and (a.depth == b.depth).all()
    assert (a.color != c.color).any()
