#!/usr/bin/env python3
"""Run chip_smoke.py's phase 12 alone on one CUDA card: the evaluation and
offline entry points of legslam_torch ([eval], [run_legs_slam], [miou],
[offline], [detect], [ae]; see chip_smoke.evaluation_phase).

    python3 tools/eval_phase.py

Builds the kernels from the checkout, makes phase 6's seeded encoder on
the card, runs the phase with its gates and prints its lines, then the
launches over the phase and the card's name and power limit. Exits 1 if
a gate failed and 2 without a card. Its outputs go under
build/chip_smoke_evaluation/.
"""
from __future__ import annotations

import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("eval_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smoke.card_line()
    smoke.build_phase()
    enc, _ = smoke.seeded_encoder(dev)
    fails: list[str] = []
    t0 = time.perf_counter()
    launches = smoke.evaluation_phase(
        dev, card, fails, str(ROOT / "build" / "chip_smoke_evaluation"), enc)
    print(f"[phase 12] {time.perf_counter() - t0:.1f} s; launches over the "
          f"phase {launches} [{card}]")
    if fails:
        print("eval_phase FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
