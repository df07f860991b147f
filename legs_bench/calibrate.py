"""Readings behind the limits of a cell's comparison, on the card.

    python3 legs_bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

Runs the cell once a seed in one process (the kernels build once), each
with a window of --seconds, and prints a JSON line a seed with the
numbers compared (`program`) and, with --control, the numbers the
control reads (`control`: the reference in the precision below the
configuration's, put in the program's place; legs_bench/loop_check.py).
The benchmark's own runs never run the control. The lower reading of a
number is the largest over the program's sound runs, its upper the
smallest over the control's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

from legs_bench import harness, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    bench = harness.load_bench(run.ROOT)
    spec = harness.cell_spec(run.ROOT, bench, a.workload)
    run.cache_dirs(run.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    limits = run.limits_of(a.workload)
    for seed in a.seeds:
        args = argparse.Namespace(seed=seed, seconds=a.seconds, trace=0,
                                  workload=a.workload)
        res = run.execute(args, spec, dev, limits, time.time(),
                          control=a.control)
        print(json.dumps(dict(
            seed=seed, info=res["info"], e2e=res["e2e"],
            program={k: v["value"] for k, v in res["checks"].items()},
            control=res["control"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
