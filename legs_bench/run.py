"""The benchmark of legslam_torch on one H100.

    python3 legs_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is an entry of BENCHMARK.json;
its configuration, traffic and per-layer readers are files under
legs_bench/ found by name (legs_bench/harness.py). The run makes its
inputs and weights from the seed, warms up every shape the cell uses,
measures a window of --seconds (--trace 0: the cell's end-to-end
metrics; a loop cell's window is the fixed number of frames its traffic
gives for each of those seconds) or traces shorter windows with
torch.profiler (--trace 1: its per-layer metrics), then compares what the window produced with the plain reference
under legs_bench/reference/. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error. Exits non-zero with no result without a card, or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

from legs_bench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so only a checkout's first run builds."""
    os.environ["LEGSLAM_TORCH_BUILD_DIR"] = str(root / "build" /
                                                "legs_bench" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "legs_bench" /
                                         "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "legs_bench" /
                                             "torch_extensions")


def execute(args, spec: dict, device, limits: dict, t_start: float,
            control: bool = False) -> dict:
    """Drive the cell's traffic on `device` and compare its outputs: the
    driver's result (no check for a card here). `control` also reads the
    control's numbers (legs_bench/calibrate.py)."""
    driver = importlib.import_module(
        f"legs_bench.drivers.{spec['traffic']['driver']}")
    ctx = SimpleNamespace(seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device,
                          config=spec["config"], traffic=spec["traffic"],
                          limits=limits, t_start=t_start, control=control)
    return driver.run(ctx)


def limits_of(cell: str) -> dict:
    return json.loads((harness.HERE / "limits" / f"{cell}.json")
                      .read_text())["limits"]


def report(args, bench: dict, res: dict, device_info: dict) -> int:
    """Print the result line (and the comparison on standard error)."""
    cell = args.workload
    if args.trace:
        metrics = harness.read_per_layer(
            harness.metrics_for(bench, cell, "per_layer"),
            res["per_layer_data"])
    else:
        metrics = {m["name"]: dict(value=float(res["e2e"][m["name"]]),
                                   unit=m["unit"])
                   for m in harness.metrics_for(bench, cell, "end_to_end")}
    checks = res["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if args.trace:
        device_info = dict(device_info,
                           busy_s=res["per_layer_data"]["device"]["busy_s"],
                           window_s=res["per_layer_data"]["device"]
                           ["window_s"])
    print(json.dumps(dict(info=res["info"])), file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, res["attempted"], res["failed"],
                              metrics, device_info, checks,
                              res.get("breakdown")))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_bench(ROOT)
    spec = harness.cell_spec(ROOT, bench, args.workload)
    cache_dirs(ROOT)
    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card: this cell needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    from legs_bench import frozen
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    card = frozen.card_line()
    print(f"card: {card}", file=sys.stderr)
    with frozen.ClockSampler() as clocks:
        res = execute(args, spec, dev, limits_of(args.workload), T_START)
    print(f"clocks: {clocks.summary()}", file=sys.stderr)
    found = harness.loaded_forbidden()
    if found:
        print(f"refused: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                       count=chips, memory_peak_bytes=int(res["peak"]))
    return report(args, bench, res, device_info)


if __name__ == "__main__":
    sys.exit(main())
