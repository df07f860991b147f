"""The least time of one semi-global matching of a rectified grey pair on
one H100, for `sgm_roofline`: the larger of its bytes over the HBM rate
and its operations over the float32 CUDA-core peak (the rates of
legs_bench/frozen.py). It counts the work SGM does, whatever implements
it:

  - census: 24 comparisons and 24 bit sets a pixel, both images;
  - Hamming cost: an exclusive-or and a population count a pixel and
    disparity;
  - the four paths' recurrence: 7 operations a path, pixel and
    disparity (the step's minimum of four terms, two penalty adds, the
    previous minimum's subtraction and the cost's add), and 3 adds a
    pixel and disparity summing the paths;
  - winner-take-all: a comparison a pixel and disparity and 10
    operations a pixel for the parabola and the range test;
  - bytes: the float32 grey pair in and the float32 disparity out (the
    cost volume lives in on-chip memory in the least implementation).
"""
from __future__ import annotations

from legs_bench.frozen import PEAK_BYTES, PEAK_F32_OPS

CENSUS_BITS = 24
OPS_PATH = 7
N_PATHS = 4


def sgm_bound(height: int, width: int, num_disp: int) -> dict:
    """{"bound_ms", "bound_by", "ops", "bytes"} of one SGM."""
    pixels = height * width
    volume = pixels * num_disp
    ops = 2 * pixels * CENSUS_BITS * 2 + volume * 2 + \
        volume * (N_PATHS * OPS_PATH + N_PATHS - 1) + volume + pixels * 10
    nbytes = 2 * pixels * 4 + pixels * 4
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations", ops=ops,
                bytes=nbytes)
