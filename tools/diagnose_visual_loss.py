#!/usr/bin/env python3
"""Whether the JAX package's visual tracker loses the same frames as the
port's on chip_smoke.py's [visual] room, on the CPU.

    python3 tools/diagnose_visual_loss.py [--frames 16] [--counts 200000 40000]

The room is [visual]'s (1200x680, seed 3, 0.15 revolution, surface-only),
at each gaussian count; its first `--frames` frames are rendered once with
the port's SyntheticDataset on the CPU and wrapped in each package's
RGBDFrame, GT hidden, as tests/test_torch_tracking.py's run_both does.
Both RGB-D trackers take the native route: the port's library, and a
private build of the JAX core whose recorded flags must be the port's
(tests/torch_native_pin.py, which says why). One line a count: the CPU
render's seconds, each tracker's lost frames and keyframes, and the first
frame at which the operation streams, the lost-frame events or the
trajectories differ (the streams compared as in test_torch_tracking.py:
R, t within 1e-6, the rest exactly). Imports both packages: a
diagnosis, not part of the port.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke.py's VISUAL_ROOM (not imported: the script needs a card)
ROOM = dict(width=1200, height=680, seed=3, clutter_ratio=0.0,
            revolutions=0.15)
# the 40-frame orbit: the frame poses depend on the sequence length
N_FRAMES = 40


def first_diff(jops_by_frame, tops_by_frame, jlost, tlost, jtraj, ttraj):
    """The first frame whose operations, lost-frame event or trajectory
    row differ between the two trackers, or None."""
    from tests.test_torch_tracking import assert_streams_equal
    for i, (jo, to) in enumerate(zip(jops_by_frame, tops_by_frame)):
        if (i in jlost) != (i in tlost):
            return i, "lost-frame event"
        try:
            assert_streams_equal(jo, to)
        except AssertionError as e:
            return i, f"operations ({str(e).splitlines()[0][:80]})"
    for k, (a, b) in enumerate(zip(jtraj, ttraj)):
        if not np.array_equal(a, b):
            return k, "trajectory row"
    return None


def run(n_gaussians: int, n_frames: int, jax_core) -> str:
    from legslam_torch.data import datasets as TD
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam import tracking as TT
    from legslam_tpu.data import datasets as JD
    from legslam_tpu.slam import tracking as JT
    from tests.test_torch_tracking import as_frame
    from tests.torch_native_pin import bound
    t0 = time.perf_counter()
    ds = SyntheticDataset(**ROOM, n_frames=N_FRAMES, n_gaussians=n_gaussians,
                          device="cpu")
    frames = [ds.read(i) for i in range(n_frames)]
    render_s = time.perf_counter() - t0
    out = {}
    with bound(*jax_core):
        assert JT._use_native() and TT._use_native()
        for name, mod, data, extra in (("jax", JT, JD, {}),
                                       ("torch", TT, TD, {"device": "cpu"})):
            fe = mod.TrackingFrontend(ds.intrinsics, ransac_thresh=0.1,
                                      **extra)
            ops, lost = [], []
            for i, fr in enumerate(frames):
                before = fe.lost_frames
                fe.track(as_frame(data, fr, c2w=None))
                ops.append(list(iter(fe.queue.pop_operation, None)))
                if fe.lost_frames > before:
                    lost.append(i)
            out[name] = (fe, ops, lost)
    (fj, jops, jlost), (ft, tops, tlost) = out["jax"], out["torch"]
    diff = first_diff(jops, tops, jlost, tlost, fj.trajectory()[0],
                      ft.trajectory()[0])
    return (f"[loss] {n_gaussians} gaussians, frames 0-{n_frames - 1} of "
            f"the {N_FRAMES}-frame {ROOM['width']}x{ROOM['height']} room: "
            f"CPU render {render_s:.1f} s; jax lost {len(jlost)} at {jlost}, "
            f"{fj.n_keyframes_created} keyframes; torch lost {len(tlost)} at "
            f"{tlost}, {ft.n_keyframes_created} keyframes; first difference: "
            f"{'none' if diff is None else f'frame {diff[0]}, {diff[1]}'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--counts", type=int, nargs="+",
                    default=[200_000, 40_000])
    args = ap.parse_args(argv)
    os.environ["LEGSLAM_NATIVE_TRACKING"] = "1"
    from tests import torch_native_pin as NP
    d = ROOT / "build" / "diagnose_visual_loss"
    lib = NP.build_jax_core(d)
    if lib is None:
        print("diagnose_visual_loss: g++ failed to build the JAX core",
              file=sys.stderr)
        return 1
    flags, want = NP.recorded_flags(lib), list(NP.port_flags())
    if flags != want:
        print(f"diagnose_visual_loss: the JAX core was built with {flags}, "
              f"the port's with {want}", file=sys.stderr)
        return 1
    print(f"[loss] both cores built with {' '.join(flags)}", flush=True)
    for n in args.counts:
        print(run(n, args.frames, (d / NP.JAX_SRC.name, lib)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
