"""What every cell of the benchmark shares: finding a cell's configuration,
traffic and metric readers by name, the statistics, the guard against
JAX, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
the file that BENCHMARK.json's `configs` entry names; its traffic is
legs_bench/traffic/<traffic>.json, whose "driver" names the general
generator that reads it (legs_bench/drivers/<driver>.py); a per-layer
metric is read by legs_bench/metrics/<name>.py. A later cell, mix or
metric is a new file and a new entry: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "legslam_tpu")


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(root: Path, bench: dict, name: str) -> dict:
    """The cell, its configuration and its traffic, each read from its own
    file; ValueError for a cell that BENCHMARK.json does not hold."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return dict(cell=cell, config=config, traffic=traffic)


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that the cell reports: those
    without a `workloads` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(
        "legs_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(entries: list, data: dict) -> dict:
    """{name: {"value", "unit"}} of the per-layer metrics whose readers
    found something to read; a reader that finds nothing returns None and
    its metric is left out."""
    out = {}
    for m in entries:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(data)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def quantile(values, q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def loaded_forbidden() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_lines(checks: dict) -> list:
    """One line per compared number: its name, its reading and its
    limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"({'ok' if v['value'] <= v['limit'] else 'FAILS'})"
            for k, v in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
