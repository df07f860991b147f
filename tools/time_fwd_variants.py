#!/usr/bin/env python3
"""Time forms of the forward compositing kernel side by side on one CUDA
card, on the main path's inputs.

    python3 tools/time_fwd_variants.py A.cu B.cu ...
    python3 tools/time_fwd_variants.py --split PARENT.cu

Each source is a copy of legslam_torch/csrc/composite_fwd.cu in some form
(it exports legslam_composite_fwd and includes composite_common.cuh from
legslam_torch/csrc). All are built at once with the port's nvcc flags
into build/fwd_variants/ (each build's registers and spills of the
<72, bf16> instantiation are printed), then called through ctypes on
chip_smoke.py's main-path scene (1200x680, 200k gaussians, bf16 pair
features): on the first step's inputs, each form's t_final/kfin digest
(chip_smoke.fwd_digest), whether it equals the first form's, and
chip_smoke's acc/t_final gate against the plain version; then on a reuse
step's inputs (after two refresh groups), CUDA-event times of 20 launches,
the forms in turns (A B .. B A, twice). The card's name, power limit and
SM clock go beside the times.

--split derives three forms from a thread-per-pixel source whose feature
sum is a C-wide FMA loop over staged rows (the design of the forward
before its redesign, e.g. `git show 3893bf2:legslam_torch/csrc/
composite_fwd.cu`): the loop cut to one channel, the feature rows loaded
from fixed rows (the tile's first, L1-resident), and both. Their times
against the source's split it into the feature sum, the rows' load
latency and the rest.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402
from legslam_torch import _build  # noqa: E402

OUT = ROOT / "build" / "fwd_variants"


def split_forms(src: str) -> dict[str, str]:
    """The --split forms of a thread-per-pixel forward source."""
    fma = ("for (int c = 0; c < NCH; ++c) "
           "acc[c] = fmaf(w, s_feat[j][c], acc[c]);")
    one = "acc[0] = fmaf(w, s_feat[j][0], acc[0]);"
    ld = "load_feat(feats + static_cast<size_t>(lo) * NCH + i)"
    fixed = "load_feat(feats + static_cast<size_t>(start) * NCH + i)"
    if fma not in src or ld not in src:
        raise ValueError("not a thread-per-pixel forward with a C-wide "
                         "FMA loop over staged rows")
    return {"source": src, "fma_one_channel": src.replace(fma, one),
            "feat_loads_fixed_rows": src.replace(ld, fixed),
            "both": src.replace(fma, one).replace(ld, fixed)}


def build(forms: dict[str, str]) -> dict:
    """Build every form at once; returns {name: C function}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in forms.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = (OUT / f"{name}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{out}")
        lines = out.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line and "ILi72E" in line \
                    and "bfloat16" in line:
                tail = " ".join(x.split("info    :")[-1].strip()
                                for x in lines[k + 2:k + 4])
                print(f"[build] {name} <72, bf16>: {tail}")
        fn = ctypes.CDLL(str(so)).legslam_composite_fwd
        # forms from before the bucketed layout take no n_buckets
        fn.buckets = "int n_buckets," in forms[name]
        fn.argtypes = [vp, vp, vp, vp] + [i] * (7 + fn.buckets) + \
            [vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, args):
    """One launch of a form's C entry, as composite_forward makes it (a
    flat layout: one range a tile)."""
    start, count, geo, feats, tile_w, tile_h, ntx, chunk = args[:8]
    ntiles, npix, nch = start.shape[0], tile_w * tile_h, feats.shape[1]
    dev = geo.device
    acc = torch.empty(ntiles, npix, nch, device=dev)
    tfin = torch.empty(ntiles, npix, device=dev)
    kfin = torch.zeros(ntiles, dtype=torch.int32, device=dev)
    err = fn(start.data_ptr(), count.data_ptr(), geo.data_ptr(),
             feats.data_ptr(), int(feats.dtype == torch.bfloat16), nch,
             ntiles, *([1] if fn.buckets else []), tile_w, tile_h, ntx,
             chunk, acc.data_ptr(), tfin.data_ptr(), kfin.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")
    return acc, tfin, kfin


def gate(acc, tfin, acc_p, tfin_p):
    """chip_smoke.check_kernels' forward gate: (pixels outside the
    tolerance, the largest T there, max |acc error| elsewhere)."""
    bad = smoke.fwd_outside(acc, tfin, acc_p, tfin_p)
    n = int(bad.sum())
    t_max = float(torch.maximum(tfin, tfin_p)[bad].max()) if n else 0.0
    e = float((acc - acc_p)[~bad].abs().max()) if n < bad.numel() \
        else float("nan")
    return n, t_max, e


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.split:
        forms = split_forms(Path(args.sources[0]).read_text())
    else:
        # numbered: two forms may share a file name
        forms = {f"{i}_{Path(p).stem}": Path(p).read_text()
                 for i, p in enumerate(args.sources)}
    card = smoke.card_line()
    fns = build(forms)
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops.cuda.composite import composite_forward_plain
    dev = torch.device("cuda")
    st, view, gt = smoke.make_scene(dev, 1200, 680, 200_000, 1 << 18, seed=0)
    first = smoke.StepLoop(G.copy_state(st), view, gt,
                           smoke.make_cfg(1 << 20, "bfloat16"))
    fa_first, _ = smoke.capture_kernel_inputs(
        lambda: first.step(first._binning()))
    drv = smoke.StepLoop(st, view, gt, smoke.make_cfg(1 << 20, "bfloat16"))
    for _ in range(2):
        drv.group()
    fa, _ = smoke.capture_kernel_inputs(lambda: drv.step(drv.binning))
    acc_p, tfin_p, _ = composite_forward_plain(*fa_first)
    names = list(fns)
    ref = None
    for n in names:
        acc, tfin, kfin = call(fns[n], fa_first)
        torch.cuda.synchronize()
        digest = smoke.fwd_digest(tfin, kfin)
        ref = ref or digest
        nbad, t_max, e = gate(acc, tfin, acc_p, tfin_p)
        print(f"[check] {n}: first step's t_final/kfin digest {digest} "
              f"(equal to {names[0]}'s: {digest == ref}); {nbad} pixels "
              f"outside the forward gate (T <= {t_max:.3g} there), max "
              f"|acc - plain| elsewhere {e:.3g}")
    times = {n: [] for n in names}
    with smoke.ClockSampler() as clk:
        for _ in range(2):
            for n in names + names[::-1]:
                times[n].append(smoke.event_ms(lambda: call(fns[n], fa), 20))
    for n in names:
        print(f"[time] {n}: {statistics.mean(times[n]):.4f} ms (runs "
              f"{[round(x, 4) for x in times[n]]}) [{card}]")
    print(f"[clocks] {clk.summary()} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
