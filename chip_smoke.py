#!/usr/bin/env python3
"""Build legslam_torch's CUDA kernels and drive the port's mapping step, its
online mapper, its language-feature encoder, its RGB-D system loop and its
open-vocabulary query and serving stack on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the kernel build: seconds, and registers / shared memory / spills per
     kernel from ptxas;
  3. at the bench smoke shape (320x192, 20k gaussians in capacity 2^15,
     max_pairs 2^16, chunk 256), in float32 and bfloat16 pair features:
     the "cuda" backend's render and gradients against the "torch"
     reference compositor, and each kernel against its plain PyTorch
     version on the inputs the mapping step gives it;
  4. the main path at Replica scale: 1200x680, 200k gaussians in capacity
     2^18, 64-D language features, bf16 pair features, binning refreshed
     every 8 steps with the termination-aware trim of the cached binning
     and of the fresh one (the schedule of bench.py:366-494); one warm-up
     group and 2 timed groups of 8 steps, with each kernel's launch count
     over those 24 steps, then each kernel against its plain version on
     the first step's inputs (the initial store, the same in every run),
     with a digest of the forward's t_final and kfin there, and CUDA-event
     times on a reuse step's inputs, with the bound; the SM
     clock, power draw and temperature are sampled beside the step and
     the kernel timings; then the radix sort kernels at the main path's
     shapes, as bin_gaussians launches them with cuda_sort: the scene's
     [2^23] pair-key buffer through sort_keys over the sentinel's 27 bits
     and argsort_f32's mode on its 2^18 depths and mask; and 2^23 random
     keys with many duplicates through sort_keys and the lexicographic
     sort_kv; each against its plain version bit for bit, with CUDA-event
     times of the kernel, the plain version and torch.sort (in turns:
     torch.sort, kernel, kernel, torch.sort), and the bound;
  5. the online mapper at full width: a 40-frame 1200x680 sequence of
     the synthetic room of 200k gaussians rendered on the card, a
     trajectory frontend (every 4th frame a keyframe) with a seeded
     37x37x64 LF grid a frame standing in for the encoder, GaussianMapper
     at capacity 2^18 with the "cuda" backend, bf16 pair features and
     cuda_sort, binning refreshed every 8 uses with both trims, densify
     every 50 iterations, 7 iterations a frame once the map starts, then
     the tail, save and the keyframe metrics; one [mapper] line with the
     iterations, keyframes, gaussians, capacity rungs, escalations, ms per
     iteration, fresh binnings and each kernel's launches, and PSNR
     against the initial map's and a gray image's; the final state's
     binning with cuda_sort on and off, and before and after growing the
     store a rung, equal bit for bit; then the same run with float32
     pair features on the kernels and on the "torch" compositor with
     torch.sort, whose PSNRs must match (see mapper_phase);
  6. the system path: [encoder] the DINOv2 + PCA language-feature encoder
     on the card, the full-size golden fixture against its goldens and
     the full ViT-B/14-reg (seeded) on a 1200x680 frame against the same
     encoder on the CPU, and its ms a frame beside its FLOPs and bound
     (see encoder_phase); [system] the 40 frames of phase 5 through the
     app's own per-frame function (apps/replica_rgbd.process_frame) with
     that encoder on every frame, the GT-pose frontend and the mapper on
     the four kernels: frames/s, ms a frame, the encoder's ms a frame, the
     kernels' launches, and the gates of system_phase;
  7. the query and serving stack (see query_phase): [query text] the CLIP
     ViT-B/16 text tower, the Talk2DINO projection and phase 6's PCA on
     SCANNET20 x 7 templates of seeded token ids, timed against its
     bound and checked against the CPU; [query map] phase 4's cloud with
     a planted object whose LF anti-aligns with one category's
     embedding, saved as a PLY with a cameras.json of 8 1200x680 views;
     [query server] the stdlib HTTP server answering /health and three
     /find_objects requests over that PLY; [query pixel] the app's
     pixel-space search with PAMR on the "cuda" backend (the forward and
     both sort kernels), against the "torch" compositor on the card;
     [query image] PAMR, the CLIP ViT-B/16 vision query and LPIPS(alex),
     card against CPU;
  8. a {"kernels": [...]} line, then the card line, then as the last line
     {"ok": true, "device": {...}}.

Each kernel's `launches` is its count over the path that runs it: the
compositing kernels' over phase 4's 24 steps, the sort kernels' over
phase 5's training loop (phase 4 runs cuda_sort at its default and
counts their launches too); `query_launches` is its count over phase 7's
pixel-space search.
It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# float32 CUDA-core peak and HBM rate of one H100 SXM at its 700 W limit
# (NVIDIA data sheet, dense)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Operations counted per (pair, pixel) for the bound (f32 ops; exp and log1p
# count as one): every evaluated pair-pixel runs the alpha chain (dx, dy,
# the 9-op quadratic, exp, the opacity product, the clamp, two tests); a
# kept one adds log1p, the transmittance add and the termination test; a
# contributing one adds, in the forward, exp, w, the t_final add and C
# FMAs, and in the backward exp, w, the C-FMA dot product dw, the prefix,
# suffix and dalpha arithmetic, plus C FMAs of the dfeats reduction and
# the dx, dy and 6 moment products.
OPS_EVAL = 16
OPS_KEEP = 3


def ops_fwd_contrib(c: int) -> int:
    return 2 * c + 3


def ops_bwd_contrib(c: int) -> int:
    return 4 * c + 24


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


class ClockSampler:
    """Samples the card's SM clock, power draw and temperature with
    nvidia-smi every 100 ms while the block runs, so times taken in two
    calls can be compared against the clocks they ran at. The sampling
    process is stopped on exit; no samples reads "not measured"."""

    FIELDS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"

    def __enter__(self):
        self.rows = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        return False

    def summary(self) -> str:
        if not self.rows:
            return "clocks not measured"
        sm, mx, pw, temp = zip(*self.rows)
        return (f"SM clock median {statistics.median(sm):.0f} MHz (min "
                f"{min(sm):.0f}, max possible {max(mx):.0f}), power draw "
                f"median {statistics.median(pw):.1f} W, temperature max "
                f"{max(temp):.0f} C, {len(sm)} samples")


# --- the bench scene (bench.py:43-93 and :320-341, without JAX) ----------

STEADY_OPACITY_QUANTILES = (
    0.0039, 0.6319, 0.9997, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
    1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def steady_state_scale_clamp(st, pts, fx: float):
    """Clamp the knn-init log-scales to the mapper's big-point prune bound
    (screen radius <= 20 px at each point's depth), as a converged store
    holds (bench.py:43-61)."""
    z = np.maximum(pts[:, 2], 0.2)
    smax = torch.as_tensor(np.log((20.0 / 3.0) * z / fx).astype(np.float32),
                           device=st.params.scaling.device)
    n = pts.shape[0]
    sc = st.params.scaling
    sc[:n] = torch.minimum(sc[:n], smax[:, None])
    return st


def steady_state_opacity(st, rng):
    """Opacities sampled from a converged store's distribution, stored as
    logits (bench.py:64-92)."""
    n = st.params.opacity.shape[0]
    qs = np.linspace(0.0, 1.0, len(STEADY_OPACITY_QUANTILES))
    u = rng.uniform(size=n)
    op = np.interp(u, qs, np.asarray(STEADY_OPACITY_QUANTILES))
    op = np.clip(op, 1e-4, 1.0 - 1e-4).astype(np.float32)
    st.params.opacity.copy_(torch.as_tensor(np.log(op / (1.0 - op))[:, None]))
    return st


def make_scene(dev, width, height, n_points, capacity, seed=0):
    """The bench's synthetic Replica-like cloud and targets."""
    from legslam_torch.models import gaussians as G
    from legslam_torch.utils.camera import CameraView
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, size=(n_points, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 8.0, size=n_points).astype(np.float32)
    cols = rng.uniform(size=(n_points, 3)).astype(np.float32)
    st = G.create_from_pcd(pts, cols, capacity=capacity, device=dev)
    st = steady_state_scale_clamp(st, pts, fx=600.0)
    st = steady_state_opacity(st, rng)
    view = CameraView.create(np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32), width, height,
                             fx=600.0, fy=600.0, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    gt = dict(
        gt_color=t(rng.uniform(size=(height, width, 3))),
        gt_lang_feat=t(rng.normal(size=(height, width, 64))),
        gt_depth=t(rng.uniform(0.5, 8.0, size=(height, width))),
        mask=torch.ones(height, width, device=dev),
        bg=torch.zeros(3, device=dev))
    return st, view, gt


def make_cfg(max_pairs, mm_dtype, backend="cuda"):
    from legslam_torch.config import RasterizeConfig
    return RasterizeConfig(tile_h=16, tile_w=128, max_span_x=4, max_span_y=8,
                           chunk=256, tile_batch=16, backend=backend,
                           max_pairs=max_pairs, mm_dtype=mm_dtype,
                           power_mode="sep3")


class StepLoop:
    """The bench's mapping-step schedule (bench.py:356-464): binning
    refreshed every `refresh` steps; the refresh step emits kfin, its
    binning is trimmed for the reuse steps, and the fresh binning of a
    group is pre-trimmed with the previous group's kfin (+1 slack chunk)
    except every 4th group."""

    def __init__(self, st, view, gt, cfg, refresh=8, slack=1,
                 fresh_max_age=3):
        from legslam_torch.config import OptimizationParams
        self.st, self.view, self.gt, self.cfg = st, view, gt, cfg
        self.opt = OptimizationParams()
        self.refresh, self.slack, self.fresh_max_age = \
            refresh, slack, fresh_max_age
        self.i = 0
        self.kfin = None
        self.binning = None
        self.fresh_age = 0

    def _binning(self):
        from legslam_torch.ops.rasterize import compute_binning
        s, v = self.st, self.view
        return compute_binning(
            s.params.xyz, torch.exp(s.params.scaling), s.params.rotation,
            s.valid, v.world_view, v.full_proj, v.tan_fovx, v.tan_fovy,
            v.width, v.height, self.cfg, max_per_tile=2048,
            opacity=torch.sigmoid(s.params.opacity[:, 0]))

    def step(self, binning, emit=False):
        from legslam_torch.mapper.train_step import train_step
        v, g = self.view, self.gt
        self.i += 1
        self.st, aux = train_step(
            self.st, v.world_view, v.full_proj, v.cam_center, v.tan_fovx,
            v.tan_fovy, g["gt_color"], g["gt_lang_feat"], g["gt_depth"],
            g["mask"], g["bg"], float(self.i), 1.0, width=v.width,
            height=v.height, active_sh_degree=3, opt=self.opt, cfg=self.cfg,
            max_per_tile=2048, binning=binning, emit_kfin=emit)
        return aux

    def group(self):
        """One refresh group; returns the last step's aux."""
        from legslam_torch.ops.binning import trim_binning
        cfg = self.cfg

        def trim(b, kfin, slack):
            return (trim_binning(b[0], kfin, cfg.max_pairs, cfg.chunk,
                                 slack), b[1])
        binning = self._binning()
        if self.kfin is not None and self.fresh_age < self.fresh_max_age:
            self.fresh_age += 1
            binning = trim(binning, self.kfin, self.slack + 1)
        else:
            self.fresh_age = 0
        aux = self.step(binning, emit=True)
        self.kfin = aux.kfin
        self.binning = trim(binning, self.kfin, self.slack)
        for _ in range(self.refresh - 1):
            aux = self.step(self.binning)
        return aux


def capture_kernel_inputs(run):
    """Run `run()` (one mapping step) and return the arguments its forward
    and backward kernel wrappers were called with."""
    from legslam_torch.ops.cuda import composite_bwd as cb
    seen = {}
    fwd, bwd = cb.composite_forward, cb.composite_backward

    def rec_fwd(*a):
        seen["fwd"] = a
        return fwd(*a)

    def rec_bwd(*a):
        seen["bwd"] = a
        return bwd(*a)
    # the wrappers count their launches on the module attribute, which is
    # the recorder while it stands in
    rec_fwd.launches = rec_bwd.launches = 0
    cb.composite_forward, cb.composite_backward = rec_fwd, rec_bwd
    try:
        run()
    finally:
        cb.composite_forward, cb.composite_backward = fwd, bwd
    return seen["fwd"], seen["bwd"]


# --- checks --------------------------------------------------------------

def close(a, b, atol, rtol):
    """max |a - b| and whether |a - b| <= atol + rtol |b| everywhere."""
    a, b = a.detach().double(), b.detach().double()
    err = (a - b).abs()
    return float(err.max()) if err.numel() else 0.0, \
        bool((err <= atol + rtol * b.abs()).all())


def fwd_digest(tfin, kfin) -> str:
    """sha256 of the forward's t_final bytes, then kfin's (16 hex digits)."""
    h = hashlib.sha256()
    for x in (tfin, kfin):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fwd_outside(acc_k, tfin_k, acc_p, tfin_p):
    """The pixels where the forward kernel's acc or t_final is outside
    check_kernels' tolerance of its plain version's."""
    atol = torch.full((acc_p.shape[-1],), 3e-5, device=acc_p.device)
    atol[3:-1] = 2e-4
    return ((acc_k - acc_p).abs() > atol + 1e-3 * acc_p.abs()).any(-1) | \
        ((tfin_k - tfin_p).abs() > 3e-5 + 1e-3 * tfin_p.abs())


def check_kernels(fwd_args, bwd_args, label, card, fails):
    """Each kernel against its plain version on the same inputs. The two
    sum in different orders (sequential per pixel and float atomics
    across pixel blocks in the kernels, cumsum and matmul in the plain
    versions). Stated tolerances:
      * forward acc and t_final: atol 3e-5 / rtol 1e-3 (LF channels atol
        2e-4), the JAX suite's forward tolerance
        (tests/test_pallas_composite.py), on every pixel but those where
        the termination test T (1 - alpha) >= 1e-4 of one pair falls
        within rounding of its threshold and flips: such a pixel ends
        with T <= 1e-2 in both versions, and at most 1e-4 of the pixels
        may be such;
      * kfin: equal on all but 0.5% of tiles, those off by one (the same
        rounding at a chunk end);
      * backward dgeo and dfeats: atol 2e-4 x the array's max |plain| /
        rtol 2e-2, the JAX suite's gradient tolerance
        (tests/test_pallas_grad.py) scaled to the gradients' magnitude.
    The line also prints a digest of the kernel's t_final and kfin (see
    fwd_digest), to hold them bit for bit against another build's."""
    from legslam_torch.ops.cuda.composite import (composite_forward,
                                                  composite_forward_plain)
    from legslam_torch.ops.cuda.composite_bwd import (
        composite_backward, composite_backward_plain)
    acc_k, tfin_k, kfin_k = composite_forward(*fwd_args)
    torch.cuda.synchronize()
    acc_p, tfin_p, kfin_p = composite_forward_plain(*fwd_args)
    torch.cuda.synchronize()
    bad = fwd_outside(acc_k, tfin_k, acc_p, tfin_p)
    n_bad = int(bad.sum())
    ok_fwd = n_bad <= 1e-4 * bad.numel() and \
        bool((torch.maximum(tfin_k, tfin_p)[bad] <= 1e-2).all())
    good = ~bad
    e_acc = float((acc_k - acc_p)[good].abs().max())
    e_t = float((tfin_k - tfin_p)[good].abs().max())
    e_all = float(torch.maximum((acc_k - acc_p).abs().amax(-1),
                                (tfin_k - tfin_p).abs()).max())
    dk = (kfin_k.long() - kfin_p.long()).abs()
    n_kdiff = int((dk > 0).sum())
    ok5 = int(dk.max()) <= 1 and n_kdiff <= 0.005 * dk.numel()
    dgeo_k, dfe_k = composite_backward(*bwd_args)
    torch.cuda.synchronize()
    dgeo_p, dfe_p = composite_backward_plain(*bwd_args)
    torch.cuda.synchronize()
    e_g, ok6 = close(dgeo_k, dgeo_p, 2e-4 * float(dgeo_p.abs().max()), 2e-2)
    e_f, ok7 = close(dfe_k, dfe_p, 2e-4 * float(dfe_p.abs().max()), 2e-2)
    print(f"[kernels {label}] fwd t_final/kfin digest "
          f"{fwd_digest(tfin_k, kfin_k)}; fwd max|err| acc {e_acc:.3g} "
          f"t_final {e_t:.3g}"
          f" on all but {n_bad}/{bad.numel()} pixels (termination flips; "
          f"max|err| over all pixels {e_all:.3g}); kfin differs on "
          f"{n_kdiff}/{dk.numel()} tiles; bwd max|err| dgeo {e_g:.3g} "
          f"(max|dgeo| {float(dgeo_p.abs().max()):.3g}) dfeats {e_f:.3g} "
          f"(max|dfeats| {float(dfe_p.abs().max()):.3g}) [{card}]")
    for ok, what in ((ok_fwd, "acc/t_final"), (ok5, "kfin"), (ok6, "dgeo"),
                     (ok7, "dfeats")):
        if not ok:
            fails.append(f"{label}: {what} outside tolerance")
    return dict(fwd=e_all, bwd=max(e_g, e_f))


def check_backends(st, view, gt, mm_dtype, card, fails):
    """The "cuda" backend's render and gradients against the "torch"
    reference compositor on the card: color / depth / final_t atol 3e-5 /
    rtol 1e-3, LF atol 2e-4 (float32 features); gradients of a loss
    through the render atol 2e-4 / rtol 2e-2 (tests/test_pallas_grad.py).
    With bf16 features: color error < 2e-2 and gradient cosine > 0.999
    (tests/test_mm_dtype.py)."""
    from legslam_torch.ops.rasterize import render_arrays
    p = st.params
    outs, grads = {}, {}
    for backend in ("torch", "cuda"):
        cfg = make_cfg(1 << 16, mm_dtype if backend == "cuda" else "float32",
                       backend)
        xyz = p.xyz.detach().clone().requires_grad_(True)
        opl = p.opacity.detach().clone().requires_grad_(True)
        out = render_arrays(
            xyz, st.sh(), p.lang_feat, torch.sigmoid(opl[:, 0]),
            st.scales(), p.rotation, st.valid, view.world_view,
            view.full_proj, view.cam_center, view.tan_fovx, view.tan_fovy,
            view.width, view.height, gt["bg"], 3, cfg)
        loss = (out.color - gt["gt_color"]).abs().mean() + \
            0.1 * out.depth.mean() + (out.lang_feat ** 2).mean()
        loss.backward()
        outs[backend] = out
        grads[backend] = torch.cat([xyz.grad.ravel(), opl.grad.ravel()])
    a, b = outs["cuda"], outs["torch"]
    ga, gb = grads["cuda"], grads["torch"]
    cos = float(ga.double() @ gb.double() /
                (ga.double().norm() * gb.double().norm() + 1e-30))
    e_c = float((a.color - b.color).abs().max().detach())
    if mm_dtype == "float32":
        res = [close(a.color, b.color, 3e-5, 1e-3),
               close(a.depth, b.depth, 3e-5, 1e-3),
               close(a.final_t, b.final_t, 3e-5, 1e-3),
               close(a.lang_feat, b.lang_feat, 2e-4, 1e-3),
               close(ga, gb, 2e-4, 2e-2)]
        ok = all(r[1] for r in res)
        detail = " ".join(f"{n} {r[0]:.3g}" for n, r in zip(
            ("color", "depth", "final_t", "lf", "grad"), res))
    else:
        ok = e_c < 2e-2 and cos > 0.999
        detail = f"color {e_c:.3g}"
    print(f"[backends {mm_dtype}] cuda vs torch compositor max|err| {detail}; "
          f"grad cosine {cos:.7f} [{card}]")
    if not ok:
        fails.append(f"backends {mm_dtype}: outside tolerance")


# --- measurement -----------------------------------------------------------

def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@torch.no_grad()
def work_counts(start, count, geo, tile_w, tile_h, ntx, chunk, kfin):
    """(pair-pixels evaluated, kept, contributing, pair rows read) over the
    chunks each tile processes before its termination watermark kfin: what
    these inputs need, for the bound."""
    from legslam_torch.ops.cuda.composite import (LOG_TERM, chunk_alpha,
                                                  exclusive_cumsum,
                                                  tile_chunk_ranges,
                                                  tile_pixels)
    dev = geo.device
    n_eval = n_keep = n_contrib = rows = 0
    koff = torch.arange(chunk, device=dev)
    for t0 in range(0, start.shape[0], 16):
        tid = torch.arange(t0, min(t0 + 16, start.shape[0]), device=dev)
        s, e, base0, _ = tile_chunk_ranges(start[tid], count[tid], chunk)
        px, py = tile_pixels(tid, tile_w, tile_h, ntx)
        kf = kfin[tid].long()
        log_all = torch.zeros(len(tid), tile_w * tile_h, device=dev)
        for k in range(int(kf.max())):
            pos = base0[:, None] + k * chunk + koff
            in_range = (pos >= s[:, None]) & (pos < e[:, None]) & \
                (k < kf)[:, None]
            alpha = chunk_alpha(geo, pos, in_range, px, py)["alpha"]
            log1m = torch.log1p(-alpha)
            log_exc = log_all[..., None] + exclusive_cumsum(log1m)
            contrib = (log_exc + log1m >= LOG_TERM) & (alpha > 0)
            npair = int(in_range.sum())
            rows += npair
            n_eval += npair * tile_w * tile_h
            n_keep += int((alpha > 0).sum())
            n_contrib += int(contrib.sum())
            log_all = log_all + log1m.sum(-1)
    return n_eval, n_keep, n_contrib, rows


def bounds(fwd_args, kfin):
    """Least times (ms) of the forward and backward kernels on these inputs:
    the larger of bytes / HBM rate and f32 ops / CUDA-core peak."""
    start, count, geo, feats, tile_w, tile_h, ntx, chunk = fwd_args
    c = feats.shape[1]
    ntiles, npix = start.shape[0], tile_w * tile_h
    n_eval, n_keep, n_contrib, rows = work_counts(
        start, count, geo, tile_w, tile_h, ntx, chunk, kfin)
    row_bytes = 32 + c * feats.element_size()
    pix_bytes = ntiles * npix * 4
    fwd_bytes = 8 * ntiles + rows * row_bytes + pix_bytes * (c + 1) + \
        4 * ntiles
    bwd_bytes = 8 * ntiles + rows * row_bytes + pix_bytes * (2 * c + 2) + \
        geo.shape[0] * (32 + 4 * c)
    base_ops = n_eval * OPS_EVAL + n_keep * OPS_KEEP
    fwd_ops = base_ops + n_contrib * ops_fwd_contrib(c)
    bwd_ops = base_ops + n_contrib * ops_bwd_contrib(c)
    out = {}
    for name, b, o in (("fwd", fwd_bytes, fwd_ops), ("bwd", bwd_bytes,
                                                     bwd_ops)):
        tb, to = b / PEAK_BYTES * 1e3, o / PEAK_F32_OPS * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=b, ops=o)
    out["counts"] = dict(pair_pixels=n_eval, kept=n_keep,
                         contributing=n_contrib, pair_rows=rows)
    return out


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --- the sort kernels --------------------------------------------------------

def sort_launches(key_bits: int, with_values: bool = False) -> str:
    """CUDA kernel launches of one call of csrc/sort.cu's radix sort: one
    histogram, then one per digit pass, with the plan."""
    from legslam_torch.ops.cuda import sort as cs
    bits, kp, vp = cs.radix_plan(key_bits, with_values)
    return (f"{cs.launches_per_call(key_bits, with_values)} kernel launches "
            f"a call (histogram + {kp + vp} passes of {bits}-bit digits)")


def sort_bound(n: int, nbytes: int) -> dict:
    """Least time (ms) of a sort of n int32 keys that must move `nbytes`
    (each input read once, each output written once) over the HBM rate,
    against n log2 n operations (a comparison sort's count; a radix sort
    does fewer, and bytes bind either way) at the CUDA-core peak (the
    table has no integer rate; Hopper's int32 rate is half the float32
    one, which would not change which bound binds)."""
    ops = n * max(int(math.log2(n)), 1)
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bytes=nbytes, ops=ops)


def max_int_err(a, b) -> float:
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def turns_ms(kernel, library, reps):
    """CUDA-event ms of two functions timed in turns (library, kernel,
    kernel, library), each the mean of its two runs."""
    lib = [event_ms(library, reps)]
    ker = [event_ms(kernel, reps), event_ms(kernel, reps)]
    lib.append(event_ms(library, reps))
    return statistics.mean(ker), statistics.mean(lib)


def check_sorts(st, view, card, fails):
    """The sort kernels at the main path's shapes against their plain
    versions, bit for bit (a sort has one right answer), and their times
    beside torch.sort's. Returns (max errors, times, bounds)."""
    from legslam_torch.ops.binning import _tile_grid, pair_keys
    from legslam_torch.ops.cuda import sort as cs
    from legslam_torch.ops.projection import preprocess
    from legslam_torch.utils.transforms import normalize_quat
    dev = st.valid.device
    # the inputs bin_gaussians hands the kernels with cuda_sort: the
    # preprocessed depths and mask, and the pair-key buffer as it lies
    focal_x = view.width / (2.0 * view.tan_fovx)
    focal_y = view.height / (2.0 * view.tan_fovy)
    pre = preprocess(st.params.xyz, st.scales(),
                     normalize_quat(st.params.rotation), st.valid,
                     view.world_view, view.full_proj, view.width, view.height,
                     focal_x, focal_y, view.tan_fovx, view.tan_fovy, 1.0)
    cfg = make_cfg(1 << 20, "bfloat16")
    _, keys, _, _ = pair_keys(pre, view.width, view.height, cfg,
                              opacity=st.opacities())
    depth, mask = pre.depth, pre.mask
    P = depth.shape[0]
    ntx, nty = _tile_grid(view.width, view.height, cfg)
    sentinel = ntx * nty * P
    key_bits = sentinel.bit_length()
    bits = cs.argsort_bits(depth, mask)
    iota = torch.arange(bits.shape[0], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n = keys.shape[0]
    rkeys = torch.randint(-(1 << 15), 1 << 15, (n,), generator=g,
                          device=dev, dtype=torch.int32)
    rvals = torch.randint(0, 16, (n,), generator=g, device=dev,
                          dtype=torch.int32)

    out = cs.sort_keys(keys, key_bits)
    order = cs.argsort_f32(depth, mask)
    r_out = cs.sort_keys(rkeys)
    rk, rv = cs.sort_kv(rkeys, rvals)
    sync(dev)
    plain = cs.sort_keys_plain(keys)
    plain_order = cs.sort_kv_plain(bits, iota)[1]
    r_plain = cs.sort_keys_plain(rkeys)
    rk_p, rv_p = cs.sort_kv_plain(rkeys, rvals)
    stable = torch.argsort(torch.where(mask, depth, float("inf")),
                           stable=True)
    ok = dict(
        keys=torch.equal(out, plain), order=torch.equal(order, plain_order),
        stable=torch.equal(order[:P].long(), stable),
        random_keys=torch.equal(r_out, r_plain),
        random_kv=torch.equal(rk, rk_p) and torch.equal(rv, rv_p))
    errs = dict(sort_keys=max(max_int_err(out, plain),
                              max_int_err(r_out, r_plain)),
                sort_kv=max(max_int_err(order, plain_order),
                            max_int_err(rk, rk_p), max_int_err(rv, rv_p)))
    for what, good in ok.items():
        if not good:
            fails.append(f"sort kernels: {what} differs from the plain "
                         "version")
    times = {}
    with ClockSampler() as clk:
        times["sort_keys"], times["sort_keys_lib"] = turns_ms(
            lambda: cs.sort_keys(keys, key_bits), lambda: torch.sort(keys),
            20)
        times["sort_kv"], times["sort_kv_lib"] = turns_ms(
            lambda: cs.argsort_order(bits),
            lambda: torch.sort(bits, stable=True), 50)
        times["random_kv"] = event_ms(lambda: cs.sort_kv(rkeys, rvals), 20)
    times.update(
        sort_keys_plain=event_ms(lambda: cs.sort_keys_plain(keys), 20),
        sort_kv_plain=event_ms(lambda: cs.sort_kv_plain(bits, iota), 50),
        random_kv_plain=event_ms(lambda: cs.sort_kv_plain(rkeys, rvals), 5))
    # keys: read and written; argsort: keys read, the order written; kv:
    # keys and values read and written
    m = bits.shape[0]
    bnd = dict(sort_keys=sort_bound(n, 8 * n), sort_kv=sort_bound(m, 8 * m),
               random_kv=sort_bound(n, 16 * n))
    sentinel_share = float((keys == sentinel).float().mean())
    print(f"[sort] sort_keys of the {n} pair keys of the main path's binning "
          f"({sentinel_share:.1%} sentinels), key_bits {key_bits}: bit-exact "
          f"{ok['keys']}, {sort_launches(key_bits)}; kernel "
          f"{times['sort_keys']:.4f} ms, plain "
          f"{times['sort_keys_plain']:.4f} ms, torch.sort "
          f"{times['sort_keys_lib']:.4f} ms, bound "
          f"{bnd['sort_keys']['bound_ms']:.4f} ms by "
          f"{bnd['sort_keys']['bound_by']} [{card}]")
    print(f"[sort] argsort_f32 of {P} depths ({int(mask.sum())} valid) "
          f"at {m}, sort_kv's argsort mode: bit-exact {ok['order']}, the "
          f"stable order {ok['stable']}, "
          f"{sort_launches(cs.ARGSORT_KEY_BITS)}; kernel "
          f"{times['sort_kv']:.4f} ms, plain {times['sort_kv_plain']:.4f} "
          f"ms, torch.sort(stable=True) {times['sort_kv_lib']:.4f} ms, "
          f"bound {bnd['sort_kv']['bound_ms']:.5f} ms by "
          f"{bnd['sort_kv']['bound_by']} [{card}]")
    print(f"[sort] {n} random keys from 65536 values in [-32768, 32768), "
          f"random values from 16: sort_keys bit-exact {ok['random_keys']}; "
          f"sort_kv (lexicographic, {sort_launches(32, True)}) bit-exact "
          f"{ok['random_kv']}, kernel {times['random_kv']:.4f} ms, plain "
          f"{times['random_kv_plain']:.4f} ms, bound "
          f"{bnd['random_kv']['bound_ms']:.4f} ms by "
          f"{bnd['random_kv']['bound_by']} [{card}]")
    print(f"[clocks] sort timing: {clk.summary()} [{card}]")
    return errs, times, bnd


# --- phase 5: the online mapper -----------------------------------------

MAPPER_ROOM = dict(n_frames=40, width=1200, height=680, n_gaussians=200_000,
                   seed=0)


def drive_mapper(dev, ds, frames, cfg, out_dir, max_per_tile=2048):
    """Drive GaussianMapper over `frames` as the app loop does (track,
    drain, initialize_map, train_iteration; then the tail), with a seeded
    unit-norm 37x37x64 LF grid a frame standing in for the encoder.
    Returns the mapper, a copy of its store right after initialize_map,
    and the ms per iteration, synced losses and capacity rungs."""
    from legslam_torch.config import MapperParams, OptimizationParams
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    rng = np.random.default_rng(0)

    def lf_grid():
        lf = rng.normal(size=(37, 37, 64)).astype(np.float32)
        return lf / np.linalg.norm(lf, axis=-1, keepdims=True)
    frontend = TrajectoryFrontend(ds.intrinsics, kf_stride=4)
    # densify every 50 iterations from 40: four times in the run
    opt = OptimizationParams(densify_from_iter=40, densification_interval=50)
    mapper = GaussianMapper(frontend.queue, ds.intrinsics, opt=opt,
                            mp=MapperParams(min_num_initial_map_kfs=4),
                            cfg=cfg, capacity=1 << 18, result_dir=out_dir,
                            max_per_tile=max_per_tile,
                            binning_refresh_interval=8, device=dev)
    iter_ms, losses, rungs, init = [], [], [], None

    def step():
        ta = time.perf_counter()
        loss = mapper.train_iteration()
        sync(dev)
        iter_ms.append((time.perf_counter() - ta) * 1e3)
        if loss is not None:
            losses.append(loss)
        if mapper.state.capacity not in rungs:
            rungs.append(mapper.state.capacity)

    for f in frames:
        frontend.track(f, lf_image=lf_grid())
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
            init = G.copy_state(mapper.state)
        if mapper.state is not None:
            for _ in range(7):
                step()
    frontend.finish()
    mapper.drain_operations(limit=10_000)
    for _ in range(int(0.8 * opt.densification_interval)):
        step()
    return mapper, init, iter_ms, losses, rungs


@torch.no_grad()
def keyframe_psnr(mapper, state=None) -> float:
    """Mean PSNR over the mapper's keyframes at full resolution of `state`
    (the mapper's own store by default), as record_keyframe_metrics
    computes it."""
    from legslam_torch.ops import losses as L
    final = mapper.state
    mapper.state = final if state is None else state
    try:
        return statistics.mean(
            float(L.psnr_gaussian_splatting(mapper.render_from_pose(
                kf.R, kf.t, kf.views[-1].width, kf.views[-1].height).color,
                kf.gt_color[-1]))
            for kf in mapper.keyframes.values())
    finally:
        mapper.state = final


def same_binning(a, b, capacity=None) -> bool:
    """Whether two (Binning, overflow) are equal bit for bit. With
    `capacity`, b is the binning of the same store grown past it: its
    order continues past that length with the new (invalid) slots, and
    its empty pairs name the grown capacity."""
    if capacity is not None:
        g = b[0]
        b = (g._replace(order=g.order[:capacity], pair_gid=torch.where(
            g.pair_gid >= capacity, capacity, g.pair_gid)), b[1])
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and \
        torch.equal(a[1], b[1])


def render_room(dev):
    """The 40-frame 1200x680 sequence of the synthetic room of 200k
    gaussians, rendered on the card once for phases 5 and 6: (dataset,
    frames, seconds)."""
    from legslam_torch.data.synthetic import SyntheticDataset
    t0 = time.perf_counter()
    ds = SyntheticDataset(**MAPPER_ROOM, device=dev)
    frames = [ds.read(i) for i in range(len(ds))]
    sync(dev)
    return ds, frames, time.perf_counter() - t0


def mapper_phase(dev, card, fails, out_dir, ds, frames, render_s):
    """Phase 5: GaussianMapper over the 40-frame 1200x680 sequence of the
    synthetic room of 200k gaussians (render_room), with the "cuda"
    backend, bf16 pair features and cuda_sort. Returns the kernels' launch
    counts over that run and the phase's seconds.

    The room's 200k blobs of opacity 0.9 overlap into a fog whose colours
    average to gray: a flat 0.5 image scores ~25 dB PSNR on it, and a short
    online run leaves part of each keyframe uncovered (rendered black), so
    "3 dB above gray" is not a bar such a run can clear. The map has to
    earn two others instead: it beats the map the mapper started from
    (the store right after initialize_map, on the same keyframes) by 3 dB;
    and a witness independent of the four kernels: the same run on the
    "torch" reference compositor with torch.sort reaches the keyframe PSNR
    of the same run on the kernels within 0.1 dB, both with float32 pair
    features (the reference has no bf16 storage; bf16's own effect, ~0.5
    dB here, is printed). Gray's PSNR and the uncovered share are printed
    beside them.

    The store stays at the ladder's first rung (2^15) in this run, so the
    final store is also grown to the next rung (grow_capacity) and must
    bin and render bit for bit as before, through the sort kernels at the
    grown sizes."""
    import dataclasses

    from legslam_torch.config import RasterizeConfig
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops import losses as L
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import sort as cs
    secs = {"render": render_s}
    kernels = dict(composite_fwd=cf.composite_forward,
                   composite_bwd=cb.composite_backward,
                   sort_keys=cs.sort_keys, sort_kv=cs.sort_kv)

    t0 = time.perf_counter()
    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16", cuda_sort=True)
    with ClockSampler() as clk:
        for fn in kernels.values():
            fn.launches = 0
        mapper, init, iter_ms, losses, rungs = drive_mapper(
            dev, ds, frames, cfg, out_dir)
        launches = {k: fn.launches for k, fn in kernels.items()}
    secs["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mapper.save("experiment")
    stats = mapper.record_keyframe_metrics("experiment")
    psnr_init = keyframe_psnr(mapper, init)
    gray = statistics.mean(
        float(L.psnr_gaussian_splatting(torch.full_like(kf.gt_color[-1], 0.5),
                                        kf.gt_color[-1]))
        for kf in mapper.keyframes.values())
    # share of keyframe pixels the map leaves uncovered (T > 0.5)
    uncovered = statistics.mean(
        float((mapper.render_from_pose(kf.R, kf.t, kf.views[-1].width,
                                       kf.views[-1].height).final_t > 0.5)
              .float().mean()) for kf in mapper.keyframes.values())
    # the final state's binning from the newest keyframe at full
    # resolution, with the sort kernels and with torch.sort
    view = mapper.keyframes[max(mapper.keyframes)].views[-1]
    b_on, b_off = (mapper.binning_for(view, dataclasses.replace(
        mapper.cfg, cuda_sort=flag)) for flag in (True, False))
    same = same_binning(b_on, b_off)
    # the final store grown to the ladder's next rung bins (through the
    # sort kernels) and renders as before
    st = mapper.state
    cap0 = st.capacity
    cap1 = min(4 * cap0, mapper.capacity)
    mapper.state = G.grow_capacity(st, cap1)
    b_grown = mapper.binning_for(view, mapper.cfg)
    kf = mapper.keyframes[max(mapper.keyframes)]
    img_grown = mapper.render_from_pose(kf.R, kf.t, view.width, view.height)
    mapper.state = st
    img = mapper.render_from_pose(kf.R, kf.t, view.width, view.height)
    n_valid = int(st.num_valid())
    grown_same = same_binning(b_on, b_grown, cap0) and \
        torch.equal(img.color, img_grown.color) and \
        torch.equal(img.final_t, img_grown.final_t)
    secs["save_metrics"] = time.perf_counter() - t0

    # the witness: the same run on the kernels with float32 pair features,
    # and on the "torch" reference compositor with torch.sort (its
    # max_per_tile as high as the ladder goes: the kernels clip no tile)
    t0 = time.perf_counter()
    f32 = drive_mapper(dev, ds, frames, dataclasses.replace(
        cfg, mm_dtype="float32"), out_dir + "_f32")[0]
    ref, _, ref_ms, ref_losses, _ = drive_mapper(
        dev, ds, frames, RasterizeConfig(backend="torch", cuda_sort=False),
        out_dir + "_torch", max_per_tile=1 << 16)
    psnr_f32, psnr_ref = keyframe_psnr(f32), keyframe_psnr(ref)
    secs["witness"] = time.perf_counter() - t0

    finite = all(math.isfinite(x) for x in losses) and \
        all(bool(torch.isfinite(v).all()) for v in st.params.as_dict().values())
    p = sorted(iter_ms)
    print(f"[mapper] {ds.intrinsics['width']}x{ds.intrinsics['height']}, "
          f"{len(frames)} frames of {MAPPER_ROOM['n_gaussians']} gaussians, "
          f"{mapper.iteration} iterations, {len(mapper.keyframes)} keyframes,"
          f" num_valid {n_valid}, capacity rungs {rungs}, escalations "
          f"{mapper.overflow_escalations}; ms/iteration median "
          f"{statistics.median(p):.2f} p90 {p[int(0.9 * (len(p) - 1))]:.2f}"
          f"; fresh binnings {mapper.fresh_binnings}, launches {launches}; "
          f"synced losses {[round(x, 4) for x in losses[-3:]]}; keyframe "
          f"PSNR {stats['psnr']:.2f} dB (initial map {psnr_init:.2f} dB, "
          f"gray {gray:.2f} dB), DSSIM {stats['dssim']:.4f}, uncovered "
          f"pixels {uncovered:.2%}, render {stats['render_ms']:.1f} ms; "
          f"binning with cuda_sort on == off: {same}; grown to {cap1}: "
          f"binning and render unchanged {grown_same}; seconds {secs} "
          f"[{card}]")
    print(f"[mapper] witness, the same run with float32 pair features: "
          f"on the torch compositor with torch.sort {ref.iteration} "
          f"iterations, num_valid {int(ref.state.num_valid())}, escalations "
          f"{ref.overflow_escalations}, synced losses "
          f"{[round(x, 4) for x in ref_losses[-3:]]}, keyframe PSNR "
          f"{psnr_ref:.3f} dB, ms/iteration median "
          f"{statistics.median(ref_ms):.2f}; on the kernels num_valid "
          f"{int(f32.state.num_valid())}, keyframe PSNR {psnr_f32:.3f} dB "
          f"(with bf16 pair features {stats['psnr']:.3f}) [{card}]")
    print(f"[clocks] mapper loop: {clk.summary()} [{card}]")
    if not finite:
        fails.append("mapper: loss or parameters not finite")
    if mapper.iteration < 200:
        fails.append(f"mapper: {mapper.iteration} iterations < 200")
    if not stats["psnr"] >= psnr_init + 3.0:
        fails.append(f"mapper: PSNR {stats['psnr']:.2f} not 3 dB above the "
                     f"initial map's {psnr_init:.2f}")
    if not abs(psnr_f32 - psnr_ref) <= 0.1:
        fails.append(f"mapper: PSNR {psnr_f32:.3f} on the kernels not within"
                     f" 0.1 dB of the torch compositor's {psnr_ref:.3f}")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"mapper: {k} launched no time")
    for k in ("sort_keys", "sort_kv"):
        if launches[k] != mapper.fresh_binnings:
            fails.append(f"mapper: {k} launched {launches[k]} times for "
                         f"{mapper.fresh_binnings} fresh binnings")
    for k in ("composite_fwd", "composite_bwd"):
        if launches[k] != mapper.iteration:
            fails.append(f"mapper: {k} launched {launches[k]} times in "
                         f"{mapper.iteration} iterations")
    if not same:
        fails.append("mapper: the final binning differs with cuda_sort")
    if not grown_same:
        fails.append("mapper: the grown store bins or renders differently")
    return launches, secs


# --- phase 6: the encoder and the system loop --------------------------------

def encoder_flops(cfg, n_patches: int, k: int = 64) -> int:
    """Operations of one encoder forward (2 per multiply-add): the patch
    embedding, each block's qkv, logits, weights x values, projection and
    MLP products over the patches + CLS + register tokens, and the PCA.
    LayerNorm, softmax, GELU and the resize are not counted (under 1%)."""
    d, hid = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
    n = n_patches + 1 + cfg.num_registers
    patch = 2 * n_patches * 3 * cfg.patch_size ** 2 * d
    block = 2 * n * d * 3 * d + 2 * (2 * n * n * d) + 2 * n * d * d + \
        2 * (2 * n * d * hid)
    return patch + cfg.depth * block + 2 * n_patches * d * k


def seeded_encoder(dev):
    """The full ViT-B/14-reg from init_params (seed 0, drawn on the CPU)
    and a seeded orthonormal 768 -> 64 PCA with a small mean, as an
    encoder on `dev` in the default dtype; and its parameters."""
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import pca as PCA
    from legslam_torch.models.encoder import LanguageFeaturesEncoder
    cfg = D.DinoV2Config()
    dino = D.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(cfg.dim, 64)))
    pca = PCA.PCAParams(
        torch.tensor((rng.normal(size=cfg.dim) * 0.01).astype(np.float32)),
        torch.tensor(q.T.astype(np.float32)))
    return LanguageFeaturesEncoder(dino, pca, cfg, device=dev), (dino, pca)


def per_call_ms(fn, n, warmup=5):
    """Median CUDA-event ms of `fn()` over n back-to-back calls after
    `warmup`, and the median host ms a call takes to return when the card
    is idle at its start (its enqueue time: back to back, a host that runs
    ahead fills the launch queue and then waits on the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events), \
        statistics.median(host)


def encoder_phase(dev, card, fails):
    """The encoder on the card. Correctness: the full-size golden fixture
    (width 768, 12 heads, 2 blocks, HF-torch goldens) in float32 at 518x518
    and 588x546 at atol 5e-4 / rtol 2e-3 (tests/test_golden_fixtures.py);
    the full 12-block ViT-B/14-reg (seeded_encoder) in the default dtype
    (bf16 weights, float32 arithmetic) on a seeded 1200x680 frame against
    the same encoder on the CPU: every token's cosine >= 0.9999 and max
    |err| <= 1e-3 (the LF values reach ~0.16; rounding the bf16 patch
    embedding two ways on the CPU moved them by 5.4e-5). Time: CUDA-event
    ms a frame (median of 30 after 5 warm-up calls) from the host frame to
    the [37, 37, 64] grid on the card, and from a frame already on the
    card with the host's enqueue time, beside the FLOP count and the bound
    (the arithmetic is float32 on the CUDA cores). Returns the encoder."""
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models.weights_io import flatten, unflatten
    path = Path(__file__).resolve().parent / "tests" / "fixtures" / \
        "golden_dinov2_fullsize.npz"
    with np.load(path) as z:
        params = D.params_from_numpy(unflatten(
            {k[len("param:"):].replace(".", "/"): z[k] for k in z.files
             if k.startswith("param:")}), dev)
        rest = {k: z[k] for k in z.files if not k.startswith("param:")}
    gold = {}
    for which in ("", "_rect"):
        img = torch.as_tensor(rest[f"input:images{which}"], device=dev)
        got = D.forward(params, img, D.DinoV2Config(depth=2))
        want = torch.as_tensor(rest[f"golden:patchtokens{which}"],
                               device=dev)
        gold[which or "_square"], ok = close(got, want, 5e-4, 2e-3)
        if got.shape != want.shape or not ok:
            fails.append(f"encoder: golden fixture{which} outside tolerance")
    del params, rest

    enc, (dino, pca) = seeded_encoder(dev)
    from legslam_torch.models.encoder import LanguageFeaturesEncoder
    cpu_enc = LanguageFeaturesEncoder(dino, pca, enc.cfg, device="cpu")
    frame = np.random.default_rng(1).uniform(
        size=(680, 1200, 3)).astype(np.float32)
    lf = enc.create_language_features(frame)
    sync(dev)
    t0 = time.perf_counter()
    ref = cpu_enc.create_language_features(frame)
    cpu_s = time.perf_counter() - t0
    got = lf.cpu().double().reshape(-1, 64)
    want = ref.double().reshape(-1, 64)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(lf).all())
    if lf.shape != (37, 37, 64) or not finite or \
            not float(cos.min()) >= 0.9999 or not err <= 1e-3:
        fails.append(f"encoder: card vs CPU cosine min {float(cos.min())} "
                     f"max|err| {err}, shape {tuple(lf.shape)}, finite "
                     f"{finite}")
    del cpu_enc, ref

    on_card = torch.as_tensor(frame, device=dev)
    with ClockSampler() as clk:
        ms_host, _ = per_call_ms(
            lambda: enc.create_language_features(frame), 30)
        ms_dev, enqueue = per_call_ms(
            lambda: enc.create_language_features(on_card), 30)
    flops = encoder_flops(enc.cfg, 37 * 37)
    nbytes = sum(a.nbytes for a in flatten(enc._cast_params).values()) + \
        frame.nbytes + 37 * 37 * 64 * 4
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_OPS * 1e3
    bound = max(tb, to)
    print(f"[encoder] golden fixture (768 wide, 2 blocks, float32) max|err| "
          f"518x518 {gold['_square']:.3g}, 588x546 {gold['_rect']:.3g} "
          f"(gate atol 5e-4 / rtol 2e-3); ViT-B/14-reg 12 blocks seeded + "
          f"orthonormal PCA, {str(enc.dtype).split('.')[-1]} weights, on a "
          f"seeded 1200x680 frame: [37, 37, 64] card vs CPU per-token "
          f"cosine min {float(cos.min()):.8f} max|err| {err:.3g} (|LF| max "
          f"{float(want.abs().max()):.3g}; CPU forward {cpu_s:.1f} s) "
          f"[{card}]")
    print(f"[encoder] ms a frame (median of 30, CUDA events): "
          f"{ms_host:.3f} from the host frame, {ms_dev:.3f} from a frame on "
          f"the card (host enqueue {enqueue:.3f} ms); {flops / 1e9:.1f} GFLOP"
          f" a frame, {flops / 1e9 / ms_dev:.1f} TFLOP/s; bound "
          f"{bound:.3f} ms by {'bytes' if tb >= to else 'operations'} "
          f"({PEAK_F32_OPS / 1e12:.0f} TFLOP/s float32, {nbytes / 1e6:.0f} "
          f"MB) [{card}]")
    print(f"[clocks] encoder timing: {clk.summary()} [{card}]")
    return enc


class TimedEncoder:
    """An encoder whose create_language_features records CUDA events
    around each call, so the system loop reports the encoder's ms a
    frame without synchronising inside it."""

    def __init__(self, enc):
        self.enc, self.events = enc, []

    def create_language_features(self, rgb):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lf = self.enc.create_language_features(rgb)
        b.record()
        self.events.append((a, b))
        return lf


@torch.no_grad()
def keyframe_lf_cosine(mapper, state=None) -> float:
    """Mean over the mapper's keyframes of the mean per-pixel cosine
    between the LF rendered from `state` (the mapper's own by default) at
    full resolution and the keyframe's gt_lf upsampled as training does."""
    from legslam_torch.mapper.train_step import upsample_lf
    from legslam_torch.ops import losses as L
    final = mapper.state
    mapper.state = final if state is None else state
    try:
        vals = []
        for kf in mapper.keyframes.values():
            v = kf.views[-1]
            out = mapper.render_from_pose(kf.R, kf.t, v.width, v.height,
                                          include_lang_feat=True)
            vals.append(float(L.lf_cosine_similarity(
                out.lang_feat, upsample_lf(kf.gt_lf, v.height, v.width))))
        return statistics.mean(vals)
    finally:
        mapper.state = final


SYSTEM_ITERS_PER_FRAME = 7
LF_MARGIN = 0.2


def system_phase(dev, card, fails, out_dir, ds, frames, enc):
    """Phase 6: the reference's RGB-D system loop on the card through the
    app's own per-frame function (apps/replica_rgbd.process_frame): the
    40 frames of phase 5's room, the full-size seeded encoder on every
    frame, the GT-pose frontend (every 4th frame a keyframe) and
    GaussianMapper on cuda / bf16 / cuda_sort with phase 5's schedule
    (7 iterations a frame once the map starts, densify every 50 from 40,
    refresh 8), then the tail. Gates: every keyframe's gt_lf is the very
    tensor the encoder returned for its frame (bit for bit); each of the
    four kernels launched in the phase; and the map's LF is earned: the
    reference's loss ADDS the mean cosine between rendered and encoder LF
    (gaussian_mapper.cpp:716-721, replicated by both packages' losses),
    so training drives that cosine down from the initial map's (0: the
    store starts with zero LF) and the queries read the inverted
    similarity (1 - cos) / 2 (eval_harness/metrics.segment_prediction).
    The gate: the keyframes' mean cosine ends at least LF_MARGIN below the
    map right after initialize_map."""
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.config import (MapperParams, OptimizationParams,
                                      RasterizeConfig)
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import sort as cs
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    frontend = TrajectoryFrontend(ds.intrinsics, kf_stride=4)
    opt = OptimizationParams(densify_from_iter=40, densification_interval=50)
    mapper = GaussianMapper(
        frontend.queue, ds.intrinsics, opt=opt,
        mp=MapperParams(min_num_initial_map_kfs=4),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16",
                            cuda_sort=True),
        capacity=1 << 18, result_dir=out_dir, max_per_tile=2048,
        binning_refresh_interval=8, device=dev)
    init = []
    initialize = mapper.initialize_map

    def initialize_and_copy():
        initialize()
        init.append(G.copy_state(mapper.state))
    mapper.initialize_map = initialize_and_copy
    timed = TimedEncoder(enc)
    kernels = dict(composite_fwd=cf.composite_forward,
                   composite_bwd=cb.composite_backward,
                   sort_keys=cs.sort_keys, sort_kv=cs.sort_kv)
    lfs, frame_ms = {}, []
    sync(dev)
    with ClockSampler() as clk:
        for fn in kernels.values():
            fn.launches = 0
        t_start = time.perf_counter()
        for f in frames:
            t0 = time.perf_counter()
            lfs[f.index] = process_frame(
                f, frontend, mapper, timed,
                iters_per_frame=SYSTEM_ITERS_PER_FRAME)
            sync(dev)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        total_s = time.perf_counter() - t_start
        frontend.finish()
        mapper.drain_operations(limit=10_000)
        for _ in range(int(0.8 * opt.densification_interval)):
            mapper.train_iteration()
        sync(dev)
        launches = {k: fn.launches for k, fn in kernels.items()}
    enc_ms = [a.elapsed_time(b) for a, b in timed.events]
    same = [torch.equal(kf.gt_lf, lfs[fid])
            for fid, kf in mapper.keyframes.items()]
    cos_final = keyframe_lf_cosine(mapper)
    cos_init = keyframe_lf_cosine(mapper, init[0]) if init else float("nan")
    stats = mapper.record_keyframe_metrics("experiment")
    p = sorted(frame_ms)
    print(f"[system] {len(frames)} frames {ds.intrinsics['width']}x"
          f"{ds.intrinsics['height']} through "
          f"apps/replica_rgbd.process_frame: encoder on every frame, "
          f"{len(mapper.keyframes)} keyframes, {mapper.iteration} iterations "
          f"({SYSTEM_ITERS_PER_FRAME} a frame once mapping, then the tail), "
          f"num_valid {int(mapper.state.num_valid())}; "
          f"{len(frames) / total_s:.3f} frames/s, ms a frame median "
          f"{statistics.median(p):.2f} p90 {p[int(0.9 * (len(p) - 1))]:.2f}, "
          f"encoder ms a frame median {statistics.median(enc_ms):.3f} (CUDA "
          f"events); launches in the phase {launches}; keyframe gt_lf is the "
          f"encoder's tensor: {sum(same)}/{len(same)}; LF mean cosine "
          f"rendered vs encoder {cos_final:.4f} (initial map {cos_init:.4f}, "
          f"gate <= initial - {LF_MARGIN}); keyframe PSNR "
          f"{stats['psnr']:.2f} dB [{card}]")
    print(f"[clocks] system loop: {clk.summary()} [{card}]")
    if not same or not all(same):
        fails.append(f"system: {len(same) - sum(same)} of {len(same)} "
                     "keyframes' gt_lf differ from the encoder's output")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"system: {k} launched no time")
    if not cos_final <= cos_init - LF_MARGIN:
        fails.append(f"system: LF cosine {cos_final:.4f} not {LF_MARGIN} "
                     f"below the initial map's {cos_init:.4f}")
    if not math.isfinite(stats["psnr"]):
        fails.append("system: keyframe PSNR not finite")


# --- phase 7: the open-vocabulary query and serving stack --------------------

# the query map: phase 4's bench cloud (x, y in [-3, 3], z in [0.5, 8]) and
# an object planted in the empty space in front of it, seen by cameras on
# an arc 2-4 m away (all in z < 0.5, so nothing of the cloud lies between a
# camera and the object)
QUERY_MAP = dict(width=1200, height=680, fx=600.0, n_cloud=200_000,
                 capacity=1 << 18, n_object=2000, radius=0.15,
                 center=(0.0, 0.0, 0.1), n_cams=8)
# one colour for the whole object, as a real object has, so PAMR's
# image affinities hold the heat to its outline
OBJECT_RGB = np.array([0.9, 0.15, 0.1], np.float32)
QUERY_CATEGORY = "chair"
SOT, EOT = 49406, 49407            # CLIP's start / end-of-text token ids
# gates of phase 7 (stated before its first run on the card)
TEXT_COS, TEXT_ERR = 0.99999, 1e-4          # text / image query, card vs CPU
SERVER_CENTER_M = 0.05
PIXEL_CENTER_M, WITNESS_CENTER_M = 0.1, 1e-3
PAMR_ERR, LPIPS_RTOL = 1e-4, 1e-4


def token_table(categories, seed: int = 0) -> dict:
    """A fixed seeded stand-in for the CLIP tokenizer (no BPE vocabulary in
    the repository): each category's 7 template sequences as [7, 77] int32
    ids: SOT, 3-12 random word ids, EOT (the largest id, which the tower
    pools), zero padding."""
    from legslam_torch.models.talk2dino import TEMPLATES
    rng = np.random.default_rng(seed)
    table = {}
    for c in categories:
        toks = np.zeros((len(TEMPLATES), 77), np.int32)
        for i in range(len(TEMPLATES)):
            n = int(rng.integers(3, 13))
            toks[i, 0] = SOT
            toks[i, 1:n + 1] = rng.integers(1, SOT, size=n)
            toks[i, n + 1] = EOT
        table[c] = toks
    return table


def clip_text_flops(cfg, n_seq: int) -> int:
    """Operations (2 per multiply-add) of encode_text over n_seq sequences
    of cfg.context tokens: each layer's qkv, logits, weights x values,
    projection and MLP products, and the pooled projection."""
    w, n = cfg.width, cfg.context
    layer = n * 2 * (3 * w * w + w * w + 8 * w * w) + 2 * 2 * n * n * w
    return n_seq * (cfg.layers * layer + 2 * w * cfg.proj_dim)


def clip_vision_flops(cfg) -> int:
    w, n = cfg.width, cfg.tokens
    layer = n * 2 * 12 * w * w + 2 * 2 * n * n * w
    return 2 * (n - 1) * 3 * cfg.patch ** 2 * w + cfg.layers * layer + \
        2 * w * cfg.proj_dim


def lpips_flops(h: int, w: int) -> int:
    """The AlexNet trunk's convolution operations for two h x w images."""
    from legslam_torch.models.lpips import ALEX_CONVS
    total, cin = 0, 3
    for i, (cout, k, s, p) in enumerate(ALEX_CONVS):
        h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        total += 2 * h * w * cout * cin * k * k
        if i in (0, 1):
            h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        cin = cout
    return 2 * total


def build_query_map(dev, text_emb: np.ndarray, out_dir: Path):
    """Phase 4's bench cloud (seed 0, steady-state scales and opacities)
    with seeded unit LF, plus QUERY_MAP's object: n_object gaussians drawn
    uniformly in a ball, colour OBJECT_RGB, opacity 0.95, LF = -e / |e| for
    the query's embedding e (the training loss adds the cosine, so a
    trained map anti-aligns). Saved as <out_dir>/point_cloud/
    point_cloud.ply with a cameras.json of n_cams cameras on an arc 2-4 m
    from the object, looking at it; returns the object's center."""
    from legslam_torch.models import gaussians as G
    from legslam_torch.utils.ply import save_gaussian_ply
    m = QUERY_MAP
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(m["n_cloud"], 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 8.0, size=m["n_cloud"]).astype(np.float32)
    cols = rng.uniform(size=(m["n_cloud"], 3)).astype(np.float32)
    center = np.asarray(m["center"], np.float32)
    d = rng.normal(size=(m["n_object"], 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = m["radius"] * rng.uniform(size=(m["n_object"], 1)) ** (1 / 3)
    obj = (center + d * r).astype(np.float32)
    lf = rng.normal(size=(m["n_cloud"] + m["n_object"], 64))
    lf /= np.linalg.norm(lf, axis=1, keepdims=True)
    lf[m["n_cloud"]:] = -text_emb / np.linalg.norm(text_emb)
    st = G.create_from_pcd(
        np.concatenate([pts, obj]),
        np.concatenate([cols, np.tile(OBJECT_RGB, (m["n_object"], 1))]),
        capacity=m["capacity"], lang_feat=lf.astype(np.float32), device=dev)
    st = steady_state_scale_clamp(st, pts, fx=m["fx"])
    st = steady_state_opacity(st, rng)
    n = m["n_cloud"] + m["n_object"]
    st.params.opacity[m["n_cloud"]:n] = math.log(0.95 / 0.05)
    p = {k: v[:n].cpu().numpy() for k, v in st.params.as_dict().items()}
    (out_dir / "point_cloud").mkdir(parents=True, exist_ok=True)
    save_gaussian_ply(str(out_dir / "point_cloud" / "point_cloud.ply"),
                      p["xyz"], p["f_dc"], p["f_rest"], p["lang_feat"],
                      p["opacity"], p["scaling"], p["rotation"])
    cams = []
    for k in range(m["n_cams"]):
        theta = math.radians(-35 + 70 * k / max(m["n_cams"] - 1, 1))
        phi = math.radians(10 if k % 2 else -10)
        dist = 2.0 + 2.0 * ((k * 3) % m["n_cams"]) / max(m["n_cams"] - 1, 1)
        eye = center + dist * np.array([math.sin(theta) * math.cos(phi),
                                        math.sin(phi),
                                        -math.cos(theta) * math.cos(phi)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        cams.append(dict(id=k, width=m["width"], height=m["height"],
                         position=eye.tolist(),
                         rotation=np.stack([right, down, fwd], 1).tolist(),
                         fx=m["fx"], fy=m["fx"]))
    (out_dir / "cameras.json").write_text(json.dumps(cams))
    del st
    return center


def _importable(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


def _http(url, body=None):
    """(JSON reply, host ms) of a GET, or a POST of `body`."""
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        reply = json.load(r)
    return reply, (time.perf_counter() - t0) * 1e3


def _objects_json(dets, top_k=5):
    return [dict(center=[float(x) for x in d.center],
                 n_gaussians=d.n_gaussians, score=d.score)
            for d in dets[:top_k]]


def query_phase(dev, card, fails, out_dir: Path, pca):
    """Phase 7: the open-vocabulary query and serving stack on the card,
    through the port's entry points.

    [query text] the CLIP ViT-B/16 text tower at ClipTextConfig() (seed 0),
    the Talk2DINO projection 512 -> 768 with one hidden layer (seed 0) and
    phase 6's PCA, on SCANNET20 x 7 templates (140 sequences of 77 token
    ids from token_table): CUDA-event ms, FLOPs and the float32 bound;
    QUERY_CATEGORY against the same pipeline on the CPU (cosine >=
    TEXT_COS, max |err| <= TEXT_ERR). [query map] build_query_map with
    that category's embedding, saved as a PLY and loaded back by the
    server and the app. [query server] serving/api.serve_stdlib on an
    ephemeral 127.0.0.1 port: GET /health and three POST /find_objects
    ("text_emb", then "query" twice through a text encoder that runs the
    text pipeline on the card): the JSON contract, the top object within
    SERVER_CENTER_M of the planted center, each reply equal to the direct
    find_objects_in_gaussians call. [query pixel] the app's
    build_render_fn on the "cuda" backend (the forward and both sort
    kernels) with PAMR at its defaults over the cameras: the center within
    PIXEL_CENTER_M of the planted one, and the same search with the "torch"
    compositor and torch.sort on the card as a witness (same best frame,
    center within WITNESS_CENTER_M); PAMR on the best view card vs CPU
    (max |err| <= PAMR_ERR). [query image] CLIP ViT-B/16 vision (seed 0) on
    the best view through the same projection and PCA, card vs CPU
    (TEXT_COS / TEXT_ERR); LPIPS(alex) with seeded weights between two
    rendered views, card vs CPU (rtol LPIPS_RTOL). Returns the kernels'
    launches in the pixel-space search."""
    import threading

    from legslam_torch.apps.find_objects import (build_render_fn, load_map,
                                                 make_renderer, pamr_fn)
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.eval_harness.find_objects import (
        find_objects_in_gaussians, pixel_space_find_object, to_host,
        view_cosine)
    from legslam_torch.eval_harness.metrics import SCANNET20
    from legslam_torch.models import clip_text as CT
    from legslam_torch.models import clip_vision as CV
    from legslam_torch.models import lpips as LP
    from legslam_torch.models import talk2dino as T2D
    from legslam_torch.models.pamr import pamr
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import sort as cs
    from legslam_torch.serving import api

    # the text pipeline, on the card and (one category) on the CPU
    tcfg = CT.ClipTextConfig()
    cpu_pca = type(pca)(*(t.cpu() for t in pca))

    def pipeline(d):
        return (CT.init_params(tcfg, torch.Generator().manual_seed(0), d),
                T2D.init_projection(torch.Generator().manual_seed(0),
                                    device=d))
    clip, proj = pipeline(dev)
    table = token_table(SCANNET20)
    toks = torch.as_tensor(np.stack([table[c] for c in SCANNET20]),
                           device=dev)

    def embed_all():
        return T2D.build_text_embedding(SCANNET20, clip, proj, pca,
                                        tokens=toks)
    emb = embed_all()
    sync(dev)
    clip_cpu, proj_cpu = pipeline("cpu")
    want = T2D.build_text_embedding(
        [QUERY_CATEGORY], clip_cpu, proj_cpu, cpu_pca,
        tokens=table[QUERY_CATEGORY][None])
    got = emb[SCANNET20.index(QUERY_CATEGORY)].cpu().double()
    want = want[0].double()
    t_cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    t_err = float((got - want).abs().max())
    del clip_cpu, proj_cpu
    with ClockSampler() as clk:
        text_ms, text_enqueue = per_call_ms(embed_all, 10, warmup=3)
    flops = clip_text_flops(tcfg, toks.numel() // tcfg.context)
    flops += len(SCANNET20) * 2 * (512 * 768 + 768 * 768 + 768 * 64)
    nbytes = sum(t.numel() * 4 for t in (
        [v for b in clip["blocks"] for p in b.values() for v in p.values()]
        + [clip["pos_embedding"], clip["text_projection"]])) + \
        toks.numel() * (4 + tcfg.width * 4) + len(SCANNET20) * 64 * 4
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_OPS * 1e3
    print(f"[query text] CLIP ViT-B/16 text tower ({tcfg.layers} layers, "
          f"width {tcfg.width}, {tcfg.context} tokens; seed 0) + Talk2DINO "
          f"projection + phase 6's PCA on "
          f"{len(SCANNET20)} categories x 7 templates = "
          f"{toks.numel() // 77} sequences -> {tuple(emb.shape)}: "
          f"{text_ms:.3f} ms (median of 10, CUDA events; host enqueue "
          f"{text_enqueue:.3f} ms), {flops / 1e9:.1f} GFLOP, "
          f"{flops / 1e9 / text_ms:.1f} TFLOP/s; bound {max(tb, to):.3f} ms "
          f"by {'bytes' if tb >= to else 'operations'} (float32 "
          f"{PEAK_F32_OPS / 1e12:.0f} TFLOP/s); '{QUERY_CATEGORY}' card vs "
          f"CPU cosine {t_cos:.8f} max|err| {t_err:.3g} (|e| max "
          f"{float(want.abs().max()):.3g}; gates {TEXT_COS} / {TEXT_ERR}) "
          f"[{card}]")
    print(f"[clocks] query text: {clk.summary()} [{card}]")
    if not (t_cos >= TEXT_COS and t_err <= TEXT_ERR) or \
            not bool(torch.isfinite(emb).all()):
        fails.append(f"query text: card vs CPU cosine {t_cos} max|err| "
                     f"{t_err}")

    # the map
    e = to_host(emb[SCANNET20.index(QUERY_CATEGORY)])
    scene = out_dir / "scene"
    t0 = time.perf_counter()
    center = build_query_map(dev, e, scene)
    ply = str(scene / "point_cloud" / "point_cloud.ply")
    print(f"[query map] {QUERY_MAP['n_cloud']} cloud + "
          f"{QUERY_MAP['n_object']} planted gaussians (ball r "
          f"{QUERY_MAP['radius']} m at {center.tolist()}, LF = -e "
          f"'{QUERY_CATEGORY}'), PLY {Path(ply).stat().st_size / 1e6:.1f} MB, "
          f"{QUERY_MAP['n_cams']} cameras {QUERY_MAP['width']}x"
          f"{QUERY_MAP['height']}, {time.perf_counter() - t0:.1f} s")

    # the server
    def encode_queries(qs):
        return T2D.build_text_embedding(
            qs, clip, proj, pca, tokens=np.stack([table[q] for q in qs]))
    state = api.ServiceState(ply_path=ply, text_encoder=encode_queries,
                             device=str(dev))
    server = api.serve_stdlib(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health, _ = _http(url + "/health")
        payloads = [{"text_emb": e.tolist(), "query": QUERY_CATEGORY},
                    {"query": QUERY_CATEGORY},
                    {"query": QUERY_CATEGORY, "top_k": 1, "ply_path": ply}]
        replies, lat = [], []
        for body in payloads:
            reply, ms = _http(url + "/find_objects", body)
            replies.append(reply)
            lat.append(ms)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    g = state.gaussians()
    direct = find_objects_in_gaussians(g["xyz"], g["lang_feat"], e)
    direct_q = find_objects_in_gaussians(
        g["xyz"], g["lang_feat"], to_host(encode_queries([QUERY_CATEGORY]))[0])
    route = "sklearn DBSCAN" if _importable("sklearn") else \
        "single cluster (no sklearn)"
    errs = []
    for body, reply in zip(payloads, replies):
        objs = reply.get("objects") or [{}]
        top = objs[0].get("center")
        errs.append(float(np.linalg.norm(np.asarray(top) - center))
                    if top else float("inf"))
        want_objs = _objects_json(direct if "text_emb" in body else direct_q,
                                  body.get("top_k", 5))
        if sorted(reply) != ["objects", "query"] or \
                reply["query"] != QUERY_CATEGORY or \
                any(sorted(o) != ["center", "n_gaussians", "score"]
                    for o in reply["objects"]):
            fails.append(f"query server: contract broken: {sorted(reply)}")
        if reply.get("objects") != want_objs:
            fails.append("query server: reply differs from the direct "
                         "find_objects_in_gaussians call")
    print(f"[query server] serve_stdlib on 127.0.0.1:"
          f"{server.server_address[1]}: /health {health}; 3 POST "
          f"/find_objects (text_emb, query, query top_k=1 + ply_path) in "
          f"{[round(x, 2) for x in lat]} ms, median "
          f"{statistics.median(lat):.2f} ms (host clock; the first loads the "
          f"PLY); top object {(replies[0]['objects'] or [None])[0]}"
          f"; center error {[round(x, 4) for x in errs]} m (gate "
          f"{SERVER_CENTER_M}); clustering route: {route} [{card}]")
    if not health == {"status": "ok"}:
        fails.append(f"query server: /health {health}")
    if not all(x <= SERVER_CENTER_M for x in errs):
        fails.append(f"query server: center errors {errs} m")

    # the pixel-space search on the kernels, then the witness
    kernels = dict(composite_fwd=cf.composite_forward,
                   composite_bwd=cb.composite_backward,
                   sort_keys=cs.sort_keys, sort_kv=cs.sort_kv)
    split = dict(render=[], pamr=[])

    def timed(name, fn):
        def run(*a):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a)
            sync(dev)
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    render_fn, cams, raw = build_render_fn(str(scene), dev)
    sync(dev)
    with ClockSampler() as clk:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = pixel_space_find_object(
            timed("render", render_fn), cams, e,
            pamr_fn=timed("pamr", pamr_fn), scene_points=raw["xyz"])
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in kernels.items()}
    # the witness composites every pair of a tile, as the kernels do
    wit_fn, _, _ = build_render_fn(
        str(scene), dev, RasterizeConfig(backend="torch", cuda_sort=False),
        max_per_tile=1 << 16)
    t0 = time.perf_counter()
    wit = pixel_space_find_object(wit_fn, cams, e, pamr_fn=pamr_fn,
                                  scene_points=raw["xyz"])
    wit_s = time.perf_counter() - t0
    n = len(cams)
    render_ms = sum(split["render"]) / n
    pamr_ms = sum(split["pamr"]) / n
    c_err = float(np.linalg.norm(res.center - center)) \
        if res.center is not None else float("inf")
    w_err = float(np.linalg.norm(res.center - wit.center)) \
        if res.center is not None and wit.center is not None \
        else float("inf")
    heat_err = float(np.abs(res.heats - wit.heats).max())
    print(f"[query pixel] pixel_space_find_object over {n} cameras "
          f"{QUERY_MAP['width']}x{QUERY_MAP['height']} through "
          f"apps/find_objects.build_render_fn (\"cuda\" backend, f32 pair "
          f"features, cuda_sort) + PAMR (dilations 1-24, 10 iterations), "
          f"boxes labelled by "
          f"{'cv2' if _importable('cv2') else 'scipy.ndimage (no cv2)'}: best "
          f"frame {res.best_frame}, center "
          f"{None if res.center is None else np.round(res.center, 4).tolist()}"
          f" error {c_err:.4f} m (gate {PIXEL_CENTER_M}), "
          f"{len(res.viewpoints)} viewpoints; ms a view: render "
          f"{render_ms:.2f}, PAMR {pamr_ms:.2f}, the rest "
          f"{total_ms / n - render_ms - pamr_ms:.2f} (cosine, host copies, "
          f"heats, boxes; host clock with a synchronise); launches {launches}"
          f"; witness (\"torch\" compositor, torch.sort, on the card, "
          f"{wit_s:.1f} s): best frame {wit.best_frame}, center diff "
          f"{w_err:.3g} m (gate {WITNESS_CENTER_M}), max heat diff "
          f"{heat_err:.3g} [{card}]")
    print(f"[clocks] query pixel: {clk.summary()} [{card}]")
    if res.best_frame < 0 or res.best_frame != wit.best_frame:
        fails.append(f"query pixel: best frame {res.best_frame} vs witness "
                     f"{wit.best_frame}")
    if not c_err <= PIXEL_CENTER_M:
        fails.append(f"query pixel: center {c_err} m from the planted one")
    if not w_err <= WITNESS_CENTER_M:
        fails.append(f"query pixel: center {w_err} m from the witness's")
    for k in ("composite_fwd", "sort_keys", "sort_kv"):
        if launches[k] == 0:
            fails.append(f"query pixel: {k} launched no time")

    # PAMR, the image query and LPIPS on the best view, card vs CPU
    st, _ = load_map(ply, dev)
    render = make_renderer(st)

    def view(k):
        c = cams[k]
        R = np.asarray(c["rotation"], np.float32).T
        return render(R, -(R @ np.asarray(c["position"], np.float32)),
                      c["width"], c["height"], c["fx"], c["fy"])
    best = max(res.best_frame, 0)
    cam = cams[best]
    out = view(best)
    rgb, lf = out.color.clamp(0, 1), out.lang_feat
    cos = view_cosine(lf, e / np.linalg.norm(e))
    p_card = pamr(rgb, cos[..., None])[..., 0].cpu()
    p_cpu = pamr(rgb.cpu(), cos.cpu()[..., None])[..., 0]
    p_err = float((p_card - p_cpu).abs().max())

    vcfg = CV.ClipVisionConfig()
    vis = CV.init_params(vcfg, torch.Generator().manual_seed(0), dev)
    vis_cpu = CV.init_params(vcfg, torch.Generator().manual_seed(0), "cpu")
    img_card = T2D.build_image_embedding(vis, proj, pca, rgb)
    proj_cpu = T2D.init_projection(torch.Generator().manual_seed(0),
                                   device="cpu")
    img_cpu = T2D.build_image_embedding(vis_cpu, proj_cpu, cpu_pca,
                                        rgb.cpu()).double()
    i_cos = float(torch.nn.functional.cosine_similarity(
        img_card.cpu().double(), img_cpu, dim=0))
    i_err = float((img_card.cpu().double() - img_cpu).abs().max())
    img_ms, _ = per_call_ms(
        lambda: T2D.build_image_embedding(vis, proj, pca, rgb), 10, warmup=3)
    v_flops = clip_vision_flops(vcfg)

    out2 = view((best + 1) % n)
    target = out2.color.clamp(0, 1)
    tree = LP.init_params(np.random.default_rng(0))
    lp_card = LP.params_from_numpy(tree, dev)
    d_card = float(LP.lpips(lp_card, rgb, target))
    d_cpu = float(LP.lpips(LP.params_from_numpy(tree, "cpu"), rgb.cpu(),
                           target.cpu()))
    lp_ms, _ = per_call_ms(lambda: LP.lpips(lp_card, rgb, target), 10,
                           warmup=3)
    l_flops = lpips_flops(cam["height"], cam["width"])
    print(f"[query image] view {best}: {int(out.num_rendered)} pairs, "
          f"overflow {int(out.overflow_pairs)} (view {(best + 1) % n}: "
          f"{int(out2.overflow_pairs)}); PAMR card vs CPU max|err| "
          f"{p_err:.3g} (gate {PAMR_ERR}); CLIP ViT-B/16 vision (seed 0, 224^2"
          f", 197 tokens) + projection + PCA on that view: card vs CPU cosine "
          f"{i_cos:.8f} max|err| {i_err:.3g}, {img_ms:.3f} ms (CUDA events, "
          f"from the rendered view on the card), {v_flops / 1e9:.1f} GFLOP, "
          f"bound {v_flops / PEAK_F32_OPS * 1e3:.3f} ms (float32); "
          f"LPIPS(alex) seeded, view {best} vs view "
          f"{(best + 1) % n} at {cam['width']}x"
          f"{cam['height']}: card {d_card:.6f} CPU {d_cpu:.6f}, {lp_ms:.3f} "
          f"ms, {l_flops / 1e9:.1f} GFLOP [{card}]")
    if not p_err <= PAMR_ERR:
        fails.append(f"query image: PAMR card vs CPU max|err| {p_err}")
    if not (i_cos >= TEXT_COS and i_err <= TEXT_ERR):
        fails.append(f"query image: card vs CPU cosine {i_cos} max|err| "
                     f"{i_err}")
    if not (d_card > 0 and abs(d_card - d_cpu) <= LPIPS_RTOL * abs(d_cpu)):
        fails.append(f"query image: LPIPS card {d_card} CPU {d_cpu}")
    return launches


def build_phase():
    from legslam_torch import _build
    names = ("composite_fwd", "composite_bwd", "sort")
    t0 = time.perf_counter()
    secs = _build.build(names)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{n} {s:.1f} s' for n, s in secs.items()) or 'cached'})")
    for n in names:
        log = _build.log_path(n).read_text().splitlines()
        # ptxas reports per instantiation; show the main path's (72 ch)
        # and the sort's eight (keys / kv x histogram / onesweep of 4, 8
        # and 16 elements a thread)
        for i, line in enumerate(log):
            if "Compiling entry function" not in line:
                continue
            tail = " ".join(x.split("info    :")[-1].strip()
                            for x in log[i + 1:i + 4])
            if "ILi72E" in line:
                dtype = "bf16" if "bfloat16" in line else "f32"
                print(f"[build] {n} <72, {dtype}>: {tail}")
            elif n == "sort":
                form = "kv" if "ILb1E" in line else "keys"
                if "histogram" in line:
                    print(f"[build] sort histogram <{form}>: {tail}")
                else:
                    items = 16 if "Li16E" in line else \
                        4 if "Li4E" in line else 8
                    print(f"[build] sort onesweep <{form}, {items} a "
                          f"thread>: {tail}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import legslam_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: legslam_torch not found ({e})", file=sys.stderr)
        return 2
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import sort as cs

    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    fails: list[str] = []
    phase_s = {}
    t_phase = time.perf_counter()
    build_phase()
    phase_s["build"] = time.perf_counter() - t_phase

    # phase 3: smoke shape
    t_phase = time.perf_counter()
    st, view, gt = make_scene(dev, 320, 192, 20_000, 1 << 15, seed=1)
    for mm_dtype in ("float32", "bfloat16"):
        check_backends(st, view, gt, mm_dtype, card, fails)
        drv = StepLoop(st, view, gt, make_cfg(1 << 16, mm_dtype))
        binning = drv._binning()
        fa, ba = capture_kernel_inputs(lambda: drv.step(binning))
        check_kernels(fa, ba, f"320x192 {mm_dtype}", card, fails)
        del drv
    del st, view, gt
    torch.cuda.empty_cache()
    phase_s["smoke_shape"] = time.perf_counter() - t_phase

    # phase 4: the main path
    t_phase = time.perf_counter()
    st, view, gt = make_scene(dev, 1200, 680, 200_000, 1 << 18, seed=0)
    st0 = G.copy_state(st)
    drv = StepLoop(st, view, gt, make_cfg(1 << 20, "bfloat16"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main_kernels = dict(fwd=cf.composite_forward, bwd=cb.composite_backward,
                        sort_keys=cs.sort_keys, sort_kv=cs.sort_kv)
    for fn in main_kernels.values():
        fn.launches = 0
    group_ms, losses = [], []
    with ClockSampler() as clk_main:
        for g in range(3):
            t0 = time.perf_counter()
            aux = drv.group()
            loss = float(aux.loss)      # synchronises
            group_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
    launches = {k: fn.launches for k, fn in main_kernels.items()}
    steps = 3 * drv.refresh
    cuda_sort = RasterizeConfig().cuda_sort
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(group_ms[1:]) / drv.refresh
    print(f"[main] 1200x680, 200k gaussians / capacity 262144, bf16, "
          f"refresh 8 + trim + trim-fresh; loss per group "
          f"{[round(x, 6) for x in losses]}; num_rendered "
          f"{int(aux.num_rendered)} overflow_pairs {int(aux.overflow_pairs)}"
          f"; launches over {steps} steps fwd {launches['fwd']} bwd "
          f"{launches['bwd']}, cuda_sort {cuda_sort}: sort_keys "
          f"{launches['sort_keys']} sort_kv {launches['sort_kv']} "
          f"(3 fresh binnings); group ms {[round(x, 2) for x in group_ms]}; "
          f"median ms/step of the timed groups {step_ms:.3f}; "
          f"max_memory_allocated {peak_gib:.2f} GiB [{card}]")
    print(f"[clocks] main path: {clk_main.summary()} [{card}]")
    if not all(math.isfinite(x) for x in losses):
        fails.append("main: loss not finite")
    for k in ("fwd", "bwd"):
        if launches[k] != steps:
            fails.append(f"main: {k} kernel launched {launches[k]} times "
                         f"in {steps} steps")
    for k in ("sort_keys", "sort_kv"):
        if launches[k] != (3 if cuda_sort else 0):
            fails.append(f"main: {k} launched {launches[k]} times for 3 "
                         f"fresh binnings, cuda_sort {cuda_sort}")

    # the kernels against their plain versions on the first step's inputs,
    # the same in every run; the trained store is not (float atomics add in
    # no fixed order), and the termination flips it meets may land on a
    # pair at the 0.99 alpha clamp, whose pixel ends at T = 1e-2 within
    # rounding, the bound of check_kernels' exemption
    first = StepLoop(st0, view, gt, make_cfg(1 << 20, "bfloat16"))
    fa, ba = capture_kernel_inputs(lambda: first.step(first._binning()))
    errs = check_kernels(fa, ba, "1200x680 bf16", card, fails)
    del first, st0
    # timed on a reuse step's inputs
    fa, ba = capture_kernel_inputs(lambda: drv.step(drv.binning))
    _, _, kfin = cf.composite_forward(*fa)
    b = bounds(fa, kfin)
    with ClockSampler() as clk_kernels:
        times = dict(
            fwd=event_ms(lambda: cf.composite_forward(*fa), 20),
            bwd=event_ms(lambda: cb.composite_backward(*ba), 10))
    times.update(
        fwd_plain=event_ms(lambda: cf.composite_forward_plain(*fa), 2),
        bwd_plain=event_ms(lambda: cb.composite_backward_plain(*ba), 2))
    print(f"[main] kernel times at 1200x680 ({int(fa[0].shape[0])} tiles, "
          f"{int(fa[2].shape[0])} pair rows, {b['counts']}): "
          f"fwd {times['fwd']:.3f} ms (plain {times['fwd_plain']:.3f}, "
          f"bound {b['fwd']['bound_ms']:.3f} by {b['fwd']['bound_by']}); "
          f"bwd {times['bwd']:.3f} ms (plain {times['bwd_plain']:.3f}, "
          f"bound {b['bwd']['bound_ms']:.3f} by {b['bwd']['bound_by']}) "
          f"[{card}]")
    print(f"[clocks] kernel timing: {clk_kernels.summary()} [{card}]")

    # the sort kernels at the main path's shapes
    sort_errs, sort_times, sort_bnd = check_sorts(st, view, card, fails)
    del drv, st, view, gt, fa, ba
    torch.cuda.empty_cache()
    phase_s["main"] = time.perf_counter() - t_phase

    # phase 5: the online mapper
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    ds, frames, render_s = render_room(dev)
    mapper_launches, _ = mapper_phase(dev, card, fails, str(out_dir), ds,
                                      frames, render_s)
    phase_s["mapper"] = time.perf_counter() - t_phase

    # phase 6: the encoder, then the system loop with it
    t_phase = time.perf_counter()
    enc = encoder_phase(dev, card, fails)
    phase_s["encoder"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    system_phase(dev, card, fails, str(out_dir) + "_system", ds, frames, enc)
    pca = enc.pca_params
    del enc, ds, frames
    torch.cuda.empty_cache()
    phase_s["system"] = time.perf_counter() - t_phase

    # phase 7: the query and serving stack
    t_phase = time.perf_counter()
    query_launches = query_phase(dev, card, fails,
                                 Path(str(out_dir) + "_query"), pca)
    phase_s["query"] = time.perf_counter() - t_phase
    print(f"[phases] seconds {({k: round(v, 1) for k, v in phase_s.items()})}"
          f", total {sum(phase_s.values()):.1f} [{card}]")

    rows = []
    for k, name, src, tpu in (
            ("fwd", "composite_fwd", "legslam_torch/csrc/composite_fwd.cu",
             "legslam_tpu/ops/pallas/composite.py:153"),
            ("bwd", "composite_bwd", "legslam_torch/csrc/composite_bwd.cu",
             "legslam_tpu/ops/pallas/composite_bwd.py:96")):
        rows.append(dict(name=name, route="cuda", source=src, replaces=tpu,
                         launches=launches[k],
                         query_launches=query_launches[name],
                         max_abs_err=errs[k],
                         ms=times[k], plain_ms=times[f"{k}_plain"],
                         bound_ms=b[k]["bound_ms"],
                         bound_by=b[k]["bound_by"], library_ms=None))
    for name, tpu in (("sort_keys", "legslam_tpu/ops/pallas/sort.py:111"),
                      ("sort_kv", "legslam_tpu/ops/pallas/sort.py:116")):
        rows.append(dict(name=name, route="cuda",
                         source="legslam_torch/csrc/sort.cu", replaces=tpu,
                         launches=mapper_launches[name],
                         query_launches=query_launches[name],
                         max_abs_err=sort_errs[name], ms=sort_times[name],
                         plain_ms=sort_times[f"{name}_plain"],
                         bound_ms=sort_bnd[name]["bound_ms"],
                         bound_by=sort_bnd[name]["bound_by"],
                         library_ms=sort_times[f"{name}_lib"]))
    if fails:
        print("chip_smoke FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
