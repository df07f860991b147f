#!/usr/bin/env python3
"""Build legslam_torch's CUDA kernels and drive the port's mapping step, its
online mapper, its language-feature encoder, its RGB-D system loop, its
open-vocabulary query and serving stack, its visual tracking frontend
(RGB-D, stereo with SGM, monocular, the inertial modes) with the live
viewer, its bucketed, strip, multi-view and slab-skipped paths, its
lens-distorted camera, its evaluation harnesses, offline trainer and
detection CLI, and its deployment (the installed package building its own
kernels and serving from the image's command) on one NVIDIA H100.

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
     times on a reuse step's inputs, with the bound; the same for the
     render prologue's kernel pair (csrc/prologue.cu: projection, conic,
     radius, SH colour and the feature matrix, forward and backward); the SM
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
  8. the visual tracking frontend (see visual_phase, viewer_phase,
     stereo_phase, mono_phase), the tracker on its native route: [visual]
     the RGB-D TrackingFrontend alone over a 40-frame 1200x680
     surface-only room of 40k gaussians with GT hidden (route, host ms a
     frame, ATE gates), then the same frames through process_frame with
     phase 6's encoder and phase 5's mapper settings on the tracker's own
     poses (frames/s, the host ms a frame by part, the local-BA / loop /
     scale operations applied and the keyframes culled, the kernels'
     launches, the PSNR and gt_lf gates);
     [viewer] the live viewer on that mapper and tracker (/state, POST
     /params, /render against render_from_pose, the /slam_frame
     keypoints); [stereo] SGM at 752x480 with 128 disparities, the plain
     twin on the card against the CPU, the kernel route (csrc/sgm.cu)
     against the twin on the card bit for bit, both timed, the kernels'
     launches a call, then a 10-frame rectified pair sequence through
     the stereo tracker and a stereo mapper; [mono] 24 frames at 640x480
     through the monocular tracker and a monocular mapper;
  9. the last slice (see bucket_phase, strips_phase, multiview_phase,
     slabs_cull_phase, store_phase): [buckets] phase 4's scene in the
     bucketed layout (4 buckets of 2^19 pairs: an even split of
     max_pairs loses pairs): each compositing kernel
     against its plain version at 320x192 and at 1200x680, the bucketed
     render against the flat one, the kernels' and the binnings' times
     beside the flat layout's, 8 bucketed steps; [strips] the main-path
     step in 4 tile-row strips against the full render and train_step
     (loss, parameters, Adam moments, densify statistics), then phase 5's
     room through GaussianMapper(spatial_strips=4);
     [multiview] a 1-view batched tick against train_step, then the room
     through GaussianMapper(n_views=4); [slabs], [cull] p_slabs=8 and
     ellipse_cull=False on the main path against the default, and the
     room through GaussianMapper with p_slabs=8, the watermark from its
     bookkeeping against a read each step; [store]
     shard_store on one card takes the one-device path;
 10. the mapper's two store paths the earlier phases do not reach (see
     ladder_phase, loop_phase): [ladder] phase 5's room through
     GaussianMapper fed a keyframe a frame of ~3200 map points, so that
     keyframes grow the store past its first capacity rung while it
     trains; each grow keeps the old rows bit for bit, and the run keeps
     its PSNR gate; [loop] the loop-closure scene of
     tests/test_torch_mapper_ops.py through the RGB-D tracker on the host,
     its operations (and a Sim(3) loop and a scale refinement built from
     them) replayed by a mapper on the card and one on the CPU, the stores
     compared after every surgery;
 11. the lens-distorted camera and the inertial sensor modes (see
     undistort_phase, inertial_phase): [undistort] the shipped TUM fr1
     camera and mapper configs, a 24-frame 640x480 room rendered pinhole
     and distorted on the host, through the GT-pose frontend and
     GaussianMapper on the four kernels, which undistorts each keyframe
     and masks its loss; the keyframes against a CPU mapper's, the
     undistortion against the pinhole render, the mask's invalid share,
     the masked loss on the card, the PSNR; [inertial] (a) mono-inertial
     and (b) rgbd-inertial through a 4-frame blackout on [mono]'s room
     with a 200 Hz IMU stream, each beside a mapper on the card, and (c)
     the app (apps/replica_rgbd.main --frontend visual --sensor auto) on
     a EuRoC layout with imu0 written at 752x480: stereo-inertial, SGM on
     the card, the shipped EuRoC stereo mapper config cut to the time;
 12. the evaluation and offline entry points (see evaluation_phase):
     [eval] phase 5's room at the Replica camera written as a Replica
     layout and scored by eval_harness/replica_eval.evaluate_scenes with
     no cfg (the harness takes the "cuda" backend), the encoder on every
     frame and LPIPS; each keyframe rendered on the kernels and on the
     "torch" compositor in turn; [run_legs_slam] the server's POST
     /run_legs_slam on that layout; [miou] the two-class scene of
     tests/test_scannet_miou.py at 640x480 as a ScanNet layout through
     scannet_eval.evaluate_scenes with no cfg, the confusion matrix on the
     kernels against the "torch" compositor's, the comparison video;
     [offline] apps/train_offline.main (1,400 iterations, one densify)
     with its first step card against CPU and its checkpoint read back on
     the CPU; [detect] apps/detect_objects.main on [eval]'s experiment,
     the heats of every view on the kernels against the "torch"
     compositor's;
     [ae] models/autoencoder.train_autoencoder card against CPU;
 13. the deployment path (see deploy_phase): [deploy] a wheel of the tree
     built and installed with pip outside the checkout, Dockerfile.torch's
     build line run from the installed package into a fresh build
     directory, the file's CMD serving /find_objects (phase 7's request)
     and /run_legs_slam (phase 12's, cold and warm) against the
     in-process answers, the kernel launches the server reports for each
     request, and the kernel libraries the server has mapped;
 14. a {"kernels": [...]} line, then the card line, then as the last line
     {"ok": true, "device": {...}}.

Each kernel's `launches` is its count over the path that runs it: the
compositing and prologue kernels' over phase 4's 24 steps (the prologue's
forward also over its 3 fresh binnings), the sort kernels' over
phase 5's training loop (phase 4 runs cuda_sort at its default and
counts their launches too); `query_launches` is its count over phase 7's
pixel-space search, `visual_launches` over phase 8's [visual] system loop,
`ladder_launches` over phase 10's [ladder] run, `undistort_launches`
over phase 11's [undistort] run and `inertial_launches` over its three
[inertial] runs together, `eval_launches` over phase 12's [eval],
[run_legs_slam], [miou], [offline] and [detect] calls together (each
part's own count is on its line), `deploy_launches` the deployed
server's count over phase 13's first /run_legs_slam request (None for the
prologue's pair, which the server's replies do not count), and a
compositing kernel's `bucketed_*` keys are phase 9's [buckets] readings
(its launches over the 8 bucketed steps).
It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shlex
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
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
                           max_pairs=max_pairs, mm_dtype=mm_dtype)


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
    """sha256 of the forward's t_final bytes, then kfin's (16 hex digits);
    t_final's alone for a bucketed layout (no kfin)."""
    h = hashlib.sha256()
    for x in (tfin, kfin):
        if x is not None:
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
        rounding at a chunk end); a bucketed layout has none;
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
    if kfin_k is None:
        dk = torch.zeros(0)
        n_kdiff, ok5 = 0, kfin_p is None
    else:
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


def capture_prologue_inputs(run):
    """Run `run()` (one mapping step on a given binning) and return the
    arguments of its render's prologue: the forward's and the backward's
    (ops/cuda/prologue.py), each the last call of its wrapper."""
    from legslam_torch.ops.cuda import prologue as pr
    seen = {}
    fwd, bwd = pr.prologue_forward, pr.prologue_backward

    def rec_fwd(*a):
        seen["fwd"] = a
        return fwd(*a)

    def rec_bwd(*a):
        seen["bwd"] = a
        return bwd(*a)
    # the wrappers count on the module attribute, as in
    # capture_kernel_inputs
    rec_fwd.launches = rec_bwd.launches = 0
    pr.prologue_forward, pr.prologue_backward = rec_fwd, rec_bwd
    try:
        run()
    finally:
        pr.prologue_forward, pr.prologue_backward = fwd, bwd
    return seen["fwd"], seen["bwd"]


@torch.no_grad()
def check_prologue(fwd_args, bwd_args, label, card, fails):
    """The prologue kernels against their plain versions on the same
    inputs: radius, mask and depth bit for bit (binning sorts on depth);
    mean2d atol 1e-4 / rtol 1e-5, conic and the features atol 1e-5 / rtol
    1e-5 (tests/test_torch_prologue.py's value tolerances); each gradient
    atol 1e-5 x its largest plain value / rtol 1e-4
    (tests/test_torch_prologue_cuda.py's, and why). Returns the largest
    forward and backward |err|."""
    from legslam_torch.ops.cuda import prologue as pr
    pre_k, f_k = pr.prologue_forward(*fwd_args)
    torch.cuda.synchronize()
    pre_p, f_p = pr.prologue_forward_plain(*fwd_args)
    differ = {n: int((getattr(pre_k, n) != getattr(pre_p, n)).sum())
              for n in ("depth", "radius", "mask")}
    e_m, ok_m = close(pre_k.mean2d, pre_p.mean2d, 1e-4, 1e-5)
    e_c, ok_c = close(pre_k.conic, pre_p.conic, 1e-5, 1e-5)
    e_f, ok_f = close(f_k, f_p, 1e-5, 1e-5)
    g_k = pr.prologue_backward(*bwd_args)
    torch.cuda.synchronize()
    g_p = pr.prologue_backward_plain(*bwd_args)
    grads = {n: close(a, b, 1e-5 * float(b.abs().max()), 1e-4) + (
        float(b.abs().max()),) for n, a, b in zip(
        ("xyz", "scales", "quats", "sh", "offset"), g_k, g_p)
        if b is not None}
    print(f"[prologue {label}] {int(fwd_args[5])} of "
          f"{int(fwd_args[0].shape[0])} rows; elements that differ "
          f"{differ}; fwd max|err| mean2d {e_m:.3g} conic {e_c:.3g} feats "
          f"{e_f:.3g}; bwd max|err| " + ", ".join(
              f"d{n} {e:.3g} (max {m:.3g})" for n, (e, _, m) in grads.items())
          + f" [{card}]")
    for ok, what in ((not any(differ.values()), "depth/radius/mask"),
                     (ok_m, "mean2d"), (ok_c, "conic"), (ok_f, "feats"),
                     *((ok, "d" + n) for n, (_, ok, _) in grads.items())):
        if not ok:
            fails.append(f"prologue {label}: {what} outside tolerance")
    return dict(fwd=max(e_m, e_c, e_f),
                bwd=max(e for e, _, _ in grads.values()))


# float operations a row of the prologue kernels, counted from
# csrc/prologue.cu at SH degree 3 (the geometry ~270, the colour ~150; the
# backward recomputes the geometry and differentiates both): the bytes
# bind by some twentyfold, so the count only has to be of the right size
PROLOGUE_OPS_FWD = 420
PROLOGUE_OPS_BWD = 950


def prologue_bound(fwd_args) -> dict:
    """Least times (ms) of the prologue kernels on these inputs: each
    input byte of the computed rows read once and each output byte of
    every row written once, over the HBM rate, against the operations at
    the CUDA-core peak."""
    xyz, _, _, _, _, rows, sh, colors, lang_feat, offset, deg = fwd_args
    P = xyz.shape[0]
    lf = 0 if lang_feat is None else lang_feat.shape[1]
    k = 0 if sh is None or colors is not None else sh.shape[1]
    colour = 12 if colors is not None else 12 * (deg + 1) ** 2
    geo_in = 12 + 12 + 16
    fwd_bytes = rows * (geo_in + 1 + colour + 4 * lf
                        + (8 if offset is not None else 0)) + \
        P * (8 + 12 + 4 + 4 + 1 + 4 * (3 + lf + 1))
    bwd_bytes = rows * (geo_in + colour + 8 + 12 + 16) + \
        P * (geo_in + 12 * k + (8 if offset is not None else 0))
    out = {}
    for name, b, o in (("fwd", fwd_bytes, rows * PROLOGUE_OPS_FWD),
                       ("bwd", bwd_bytes, rows * PROLOGUE_OPS_BWD)):
        tb, to = b / PEAK_BYTES * 1e3, o / PEAK_F32_OPS * 1e3
        out[name] = dict(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=b, ops=o)
    return out


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
def work_counts(start, count, geo, tile_w, tile_h, ntx, chunk, kfin,
                n_buckets=1):
    """(pair-pixels evaluated, kept, contributing, pair rows read) over the
    chunks each tile processes: up to its termination watermark kfin in
    the flat layout, and over its bucket ranges in order up to the chunk
    after which every pixel has log T_all < log(1e-4) in a bucketed one
    (kfin None): what these inputs need, for the bound."""
    from legslam_torch.ops.cuda.composite import (LOG_TERM, chunk_alpha,
                                                  exclusive_cumsum,
                                                  tile_chunk_ranges,
                                                  tile_pixels)
    dev = geo.device
    n_eval = n_keep = n_contrib = rows = 0
    koff = torch.arange(chunk, device=dev)
    ntiles = start.shape[0] // n_buckets
    for t0 in range(0, ntiles, 16):
        tid = torch.arange(t0, min(t0 + 16, ntiles), device=dev)
        px, py = tile_pixels(tid, tile_w, tile_h, ntx)
        log_all = torch.zeros(len(tid), tile_w * tile_h, device=dev)
        alive = torch.ones(len(tid), dtype=torch.bool, device=dev)
        for b in range(n_buckets):
            rid = tid * n_buckets + b
            s, e, base0, n_chunks = tile_chunk_ranges(start[rid], count[rid],
                                                      chunk)
            kf = kfin[tid].long() if kfin is not None else n_chunks
            for k in range(int(kf.max())):
                running = (k < kf) & alive
                pos = base0[:, None] + k * chunk + koff
                in_range = (pos >= s[:, None]) & (pos < e[:, None]) & \
                    running[:, None]
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
                if kfin is None:
                    alive = alive & ~(running & (log_all.max(-1).values
                                                 < LOG_TERM))
    return n_eval, n_keep, n_contrib, rows


def bounds(fwd_args, kfin):
    """Least times (ms) of the forward and backward kernels on these inputs:
    the larger of bytes / HBM rate and f32 ops / CUDA-core peak. kfin is
    None for a bucketed layout (the ranges are walked to termination)."""
    start, count, geo, feats, tile_w, tile_h, ntx, chunk = fwd_args[:8]
    n_buckets = fwd_args[8] if len(fwd_args) > 8 else 1
    c = feats.shape[1]
    ntiles, npix = start.shape[0] // n_buckets, tile_w * tile_h
    n_eval, n_keep, n_contrib, rows = work_counts(
        start, count, geo, tile_w, tile_h, ntx, chunk, kfin, n_buckets)
    row_bytes = 32 + c * feats.element_size()
    pix_bytes = ntiles * npix * 4
    ranges = 8 * ntiles * n_buckets
    fwd_bytes = ranges + rows * row_bytes + pix_bytes * (c + 1) + \
        (4 * ntiles if kfin is not None else 0)
    bwd_bytes = ranges + rows * row_bytes + pix_bytes * (2 * c + 2) + \
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


def path_kernels() -> dict:
    """The kernel wrappers of the mapping path, by kernel name."""
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    from legslam_torch.ops.cuda import prologue as pr
    from legslam_torch.ops.cuda import sort as cs
    return dict(composite_fwd=cf.composite_forward,
                composite_bwd=cb.composite_backward,
                sort_keys=cs.sort_keys, sort_kv=cs.sort_kv,
                prologue_fwd=pr.prologue_forward,
                prologue_bwd=pr.prologue_backward)


# the kernels the server counts in its replies (serving/api.kernel_launches)
SERVER_KERNELS = ("composite_fwd", "composite_bwd", "sort_keys", "sort_kv")


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


def drive_mapper(dev, ds, frames, cfg, out_dir, max_per_tile=2048,
                 frontend_kw=None, intr=None, opt=None, mp=None,
                 **mapper_kw):
    """Drive GaussianMapper over `frames` as the app loop does (track,
    drain, initialize_map, train_iteration; then the tail), with a seeded
    unit-norm 37x37x64 LF grid a frame standing in for the encoder;
    frontend_kw go to the TrajectoryFrontend, mapper_kw to the mapper
    (n_views, spatial_strips, shard_store); intr, opt and mp replace the
    room's intrinsics and phase 5's schedule. Returns the mapper, a copy
    of its store right after initialize_map, the ms per iteration, the
    synced losses and the capacity rungs ({capacity: index of the first
    iteration at it})."""
    from legslam_torch.config import MapperParams, OptimizationParams
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    rng = np.random.default_rng(0)

    def lf_grid():
        lf = rng.normal(size=(37, 37, 64)).astype(np.float32)
        return lf / np.linalg.norm(lf, axis=-1, keepdims=True)
    intr = intr or ds.intrinsics
    frontend = TrajectoryFrontend(
        intr, **{"kf_stride": 4, **(frontend_kw or {})})
    # densify every 50 iterations from 40: four times in the run
    opt = opt or OptimizationParams(densify_from_iter=40,
                                    densification_interval=50)
    mapper = GaussianMapper(frontend.queue, intr, opt=opt,
                            mp=mp or MapperParams(min_num_initial_map_kfs=4),
                            cfg=cfg, capacity=1 << 18, result_dir=out_dir,
                            max_per_tile=max_per_tile,
                            binning_refresh_interval=8, device=dev,
                            **mapper_kw)
    iter_ms, losses, rungs, init = [], [], {}, None

    def step():
        rungs.setdefault(mapper.state.capacity, len(iter_ms))
        ta = time.perf_counter()
        loss = mapper.train_iteration()
        sync(dev)
        iter_ms.append((time.perf_counter() - ta) * 1e3)
        if loss is not None:
            losses.append(loss)

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
def keyframe_psnr(mapper, state=None, masked=False) -> float:
    """Mean PSNR over the mapper's keyframes at full resolution of `state`
    (the mapper's own store by default), as record_keyframe_metrics
    computes it; `masked` keeps only the pixels each keyframe's valid mask
    keeps (>= 0.999), the pixels a distorted camera's loss sees."""
    from legslam_torch.ops import losses as L
    final = mapper.state
    mapper.state = final if state is None else state
    try:
        out = []
        for kf in mapper.keyframes.values():
            img = mapper.render_from_pose(kf.R, kf.t, kf.views[-1].width,
                                          kf.views[-1].height).color
            gt = kf.gt_color[-1]
            if masked:
                keep = kf.mask[-1] >= 0.999
                img, gt = img[keep][:, None], gt[keep][:, None]
            out.append(float(L.psnr_gaussian_splatting(img, gt)))
        return statistics.mean(out)
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
    secs = {"render": render_s}
    kernels = path_kernels()

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
    for k in ("composite_fwd", "composite_bwd", "prologue_bwd"):
        if launches[k] != mapper.iteration:
            fails.append(f"mapper: {k} launched {launches[k]} times in "
                         f"{mapper.iteration} iterations")
    # one prologue a render and a fresh binning
    if launches["prologue_fwd"] != mapper.iteration + mapper.fresh_binnings:
        fails.append(f"mapper: prologue_fwd launched "
                     f"{launches['prologue_fwd']} times for "
                     f"{mapper.iteration} iterations and "
                     f"{mapper.fresh_binnings} fresh binnings")
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
    kernels = path_kernels()
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
    launches in the pixel-space search, and what phase 13 asks the
    deployed server: the PLY, the category's embedding and the reply to
    the first /find_objects request."""
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
    kernels = path_kernels()
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
    return launches, dict(ply=ply, text_emb=e.tolist(), reply=replies[0])


# --- phase 8: the visual tracking frontend, SGM stereo, mono, the viewer -----

# the [visual] room: Replica's width and the surface-only room of
# bench.py:173-176 (its 40k gaussians, n_points // 5 of the 200k-point
# store), with motion KLT can follow (1.35 deg a frame). At 200k the
# tracker loses frames 1-12 of this orbit (every frame after the bootstrap
# keyframe until it re-anchors) on every render path tried and at a third
# of the motion, and none at 10k, 20k or 40k (tools/probe_visual_room.py,
# PERF.md §4). The JAX package's tracker loses the same frames on the
# same CPU-rendered frames, its operation stream equal to the port's
# (tools/diagnose_visual_loss.py): the scene's property, not the port's.
VISUAL_ROOM = dict(n_frames=40, width=1200, height=680, n_gaussians=40_000,
                   seed=3, clutter_ratio=0.0, revolutions=0.15)
# the [stereo] pair: EuRoC's 752x480 and its 128 disparities
STEREO_SHAPE = (480, 752)
STEREO_DISP = 128
# the [stereo] and [mono] sequences: the scenes of
# tests/test_tracking_stereo.py and tests/test_tracking_mono.py at
# EuRoC's and VGA's sizes. The stereo baseline puts the room's walls
# (z 4-8 m) at 38-75 px of disparity, inside SGM's [8, 128) window.
STEREO_ROOM = dict(n_frames=10, width=752, height=480, n_gaussians=7000,
                   seed=11, clutter_ratio=0.0, revolutions=0.15)
STEREO_BASELINE = 0.5
MONO_ROOM = dict(n_frames=24, width=640, height=480, n_gaussians=7000,
                 seed=0, clutter_ratio=0.0, revolutions=0.15)
# gates (tests/test_tracking.py:79-90, test_tracking_mono.py:96-110)
VISUAL_ATE_SIM3 = 0.05
VISUAL_ATE_RAW = 0.15
MONO_ATE_SIM3 = 0.08
STEREO_SUBPIX_TOL = 1e-4


def hide_gt(frame, **changes):
    import dataclasses
    return dataclasses.replace(frame, c2w=None, **changes)


def traj_ate(fe, frames) -> tuple[float, float]:
    """(Sim(3)-aligned, unaligned) ATE RMSE of the tracker's trajectory
    against the frames' GT camera centers."""
    from legslam_torch.eval_harness.metrics import ate_rmse
    fids, traj = fe.trajectory()
    gt = np.stack([frames[int(i)].c2w for i in fids])[:, :3, 3]
    return (ate_rmse(traj[:, :3, 3], gt)["rmse"],
            ate_rmse(traj[:, :3, 3], gt, with_scale=False)["rmse"])


def pct(xs, q) -> float:
    p = sorted(xs)
    return p[int(q * (len(p) - 1))]


class OpCounter:
    """Counts the operations a mapper applies, by kind, and the keyframes
    its culling drops."""

    def __init__(self, mapper):
        self.kinds, self.culled = {}, 0
        handle, cull = mapper.handle_operation, mapper.cull_keyframes

        def counted_handle(op):
            self.kinds[op.kind.name] = self.kinds.get(op.kind.name, 0) + 1
            return handle(op)

        def counted_cull():
            n = len(mapper.keyframes)
            cull()
            self.culled += n - len(mapper.keyframes)
        mapper.handle_operation = counted_handle
        mapper.cull_keyframes = counted_cull

    def applied(self) -> dict:
        return {k: self.kinds.get(k, 0)
                for k in ("LOCAL_BA", "LOOP_CLOSE_BA", "SCALE_REFINEMENT")}


class HostTimes:
    """Host ms of the calls of wrapped methods, summed per frame: set
    `frame` before each frame's work, and back to None after the last
    (calls outside a frame are not counted)."""

    def __init__(self):
        self.frame, self.ms = None, {}

    def wrap(self, obj, name):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if self.frame is not None:
                    per = self.ms.setdefault(name, {})
                    per[self.frame] = per.get(self.frame, 0.0) + \
                        (time.perf_counter() - t0) * 1e3
        setattr(obj, name, timed)

    def per_frame(self, name, n) -> list[float]:
        per = self.ms.get(name, {})
        return [per.get(i, 0.0) for i in range(n)]


def visual_phase(dev, card, fails, out_dir, enc):
    """Phase 8 [visual]: the port's TrackingFrontend (RGB-D) on the
    40-frame 1200x680 surface-only room with GT hidden, alone (route, host
    ms a frame, the ATE gates of tests/test_tracking.py), then the same
    frames through apps/replica_rgbd.process_frame with phase 6's encoder
    and phase 5's mapper settings: the mapper's poses are the tracker's
    own, so local BA, loop-closure and culling operations reach the store
    surgery. Returns (frontend, mapper, launches)."""
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.config import (MapperParams, OptimizationParams,
                                      RasterizeConfig)
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam import tracking as T
    secs = {}
    t0 = time.perf_counter()
    ds = SyntheticDataset(**VISUAL_ROOM, device=dev)
    frames = [ds.read(i) for i in range(len(ds))]
    sync(dev)
    secs["render"] = time.perf_counter() - t0

    # the tracker alone
    t0 = time.perf_counter()
    route = "native" if T._use_native() else "cv2"
    if route == "native":
        from legslam_torch.slam import native
        route += f" ({native.library_path().name})"
    fe = T.TrackingFrontend(ds.intrinsics, ransac_thresh=0.1, device=dev)
    track_ms = []
    for f in frames:
        ta = time.perf_counter()
        fe.track(hide_gt(f))
        track_ms.append((time.perf_counter() - ta) * 1e3)
    ate_s, ate_r = traj_ate(fe, frames)
    secs["tracker"] = time.perf_counter() - t0
    print(f"[visual] tracker alone, rgbd, {len(frames)} frames "
          f"{ds.intrinsics['width']}x{ds.intrinsics['height']} of "
          f"{VISUAL_ROOM['n_gaussians']} gaussians (GT hidden), route "
          f"{route}: {fe.num_keyframes} keyframes live of "
          f"{fe.n_keyframes_created} created, lost frames {fe.lost_frames}, "
          f"loop closures {fe.n_loop_closures}; ATE RMSE Sim(3)-aligned "
          f"{ate_s:.4f} m (gate < {VISUAL_ATE_SIM3}), unaligned {ate_r:.4f} m"
          f" (gate < {VISUAL_ATE_RAW}); host ms a frame median "
          f"{statistics.median(track_ms):.2f} p90 {pct(track_ms, 0.9):.2f} "
          f"[{card}]")
    if fe.lost_frames != 0:
        fails.append(f"visual: tracker lost {fe.lost_frames} frames")
    if fe.num_keyframes < 3:
        fails.append(f"visual: {fe.num_keyframes} keyframes < 3")
    if not ate_s < VISUAL_ATE_SIM3:
        fails.append(f"visual: Sim(3) ATE {ate_s:.4f} >= {VISUAL_ATE_SIM3}")
    if not ate_r < VISUAL_ATE_RAW:
        fails.append(f"visual: unaligned ATE {ate_r:.4f} >= {VISUAL_ATE_RAW}")

    # the system loop on the tracker's poses
    t0 = time.perf_counter()
    fe = T.TrackingFrontend(ds.intrinsics, ransac_thresh=0.1, device=dev)
    opt = OptimizationParams(densify_from_iter=40, densification_interval=50)
    mapper = GaussianMapper(
        fe.queue, ds.intrinsics, opt=opt,
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
    ops = OpCounter(mapper)
    host = HostTimes()
    host.wrap(fe, "track")
    host.wrap(mapper, "drain_operations")
    host.wrap(mapper, "train_iteration")
    timed = TimedEncoder(enc)
    kernels = path_kernels()
    lfs, frame_ms = {}, []
    sync(dev)
    with ClockSampler() as clk:
        for fn in kernels.values():
            fn.launches = 0
        t_start = time.perf_counter()
        for f in frames:
            host.frame = f.index
            ta = time.perf_counter()
            lfs[f.index] = process_frame(
                hide_gt(f), fe, mapper, timed,
                iters_per_frame=SYSTEM_ITERS_PER_FRAME)
            sync(dev)
            frame_ms.append((time.perf_counter() - ta) * 1e3)
        total_s = time.perf_counter() - t_start
        host.frame = None
        mapper.drain_operations(limit=10_000)
        for _ in range(int(0.8 * opt.densification_interval)):
            mapper.train_iteration()
        sync(dev)
        launches = {k: fn.launches for k, fn in kernels.items()}
    secs["system"] = time.perf_counter() - t0
    enc_ms = [a.elapsed_time(b) for a, b in timed.events]
    same = [torch.equal(kf.gt_lf, lfs[fid])
            for fid, kf in mapper.keyframes.items()]
    psnr = keyframe_psnr(mapper)
    psnr_init = keyframe_psnr(mapper, init[0]) if init else float("nan")
    ate_s, ate_r = traj_ate(fe, frames)
    split = {k: host.per_frame(k, len(frames))
             for k in ("track", "drain_operations", "train_iteration")}
    split["rest"] = [t - sum(v[i] for v in split.values())
                     for i, t in enumerate(frame_ms)]
    sys_track_ms = split["track"]
    by_part = {k: f"{statistics.median(v):.2f} ({statistics.mean(v):.2f})"
               for k, v in split.items()}
    secs = {k: round(v, 1) for k, v in secs.items()}
    print(f"[visual] system loop, {len(frames)} frames through "
          f"apps/replica_rgbd.process_frame on the tracker's poses (GT "
          f"hidden), encoder on every frame, {SYSTEM_ITERS_PER_FRAME} "
          f"iterations a frame once mapping: {len(frames) / total_s:.3f} "
          f"frames/s, ms a frame median {statistics.median(frame_ms):.2f} "
          f"p90 {pct(frame_ms, 0.9):.2f}; tracker ms a frame median "
          f"{statistics.median(sys_track_ms):.2f} p90 "
          f"{pct(sys_track_ms, 0.9):.2f}; encoder ms a frame median "
          f"{statistics.median(enc_ms):.3f} (CUDA events); host ms a frame "
          f"by part, median (mean): {by_part} (rest: the encoder's "
          f"enqueue, initialize_map and the wait for "
          f"the card at the frame's end); operations "
          f"applied {ops.applied()}, keyframes culled {ops.culled}, tracker "
          f"loop closures {fe.n_loop_closures}; {len(mapper.keyframes)} "
          f"keyframes, {mapper.iteration} iterations, num_valid "
          f"{int(mapper.state.num_valid())}; launches {launches}; keyframe "
          f"gt_lf is the encoder's tensor: {sum(same)}/{len(same)}; "
          f"keyframe PSNR {psnr:.2f} dB (initial map {psnr_init:.2f} dB, "
          f"gate >= initial + 3); ATE Sim(3) {ate_s:.4f} m, unaligned "
          f"{ate_r:.4f} m; seconds {secs} [{card}]")
    print(f"[clocks] visual system loop: {clk.summary()} [{card}]")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"visual: {k} launched no time")
    if ops.kinds.get("LOCAL_BA", 0) < 1:
        fails.append("visual: no LOCAL_BA operation applied")
    if not psnr >= psnr_init + 3.0:
        fails.append(f"visual: PSNR {psnr:.2f} not 3 dB above the initial "
                     f"map's {psnr_init:.2f}")
    if not same or not all(same):
        fails.append(f"visual: {len(same) - sum(same)} of {len(same)} "
                     "keyframes' gt_lf differ from the encoder's output")
    return fe, mapper, launches


def textured_pair(shape, disparity, seed=0):
    """A seeded textured left image (smooth noise, bilinear from a coarse
    grid) and its right image shifted by a constant disparity."""
    h, w = shape
    rng = np.random.default_rng(seed)
    base = torch.as_tensor(rng.uniform(size=(1, 1, h // 8 + 2, w // 8 + 2)),
                           dtype=torch.float32)
    left = torch.nn.functional.interpolate(
        base, size=(h + 16, w + 16), mode="bilinear",
        align_corners=False)[0, 0, 8:8 + h, 8:8 + w].numpy()
    left = (left - left.min()) / (left.max() - left.min())
    right = np.roll(left, -disparity, axis=1)
    return left.astype(np.float32), right.astype(np.float32)


def right_view(color, depth, fx, baseline):
    """Inverse-warp a rectified right view, right(u) = left(u + fx*b/z),
    with the left depth as the sampling proxy
    (tests/test_tracking_stereo.py:21-35)."""
    h, w, _ = color.shape
    us = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    z = np.where(depth > 1e-3, depth, 1e6)
    src = np.clip(us + fx * baseline / z, 0, w - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, w - 1)
    f = (src - lo)[..., None]
    rows = np.arange(h)[:, None]
    return (color[rows, lo] * (1 - f) + color[rows, hi] * f).astype(
        np.float32)


def stereo_phase(dev, card, fails, out_dir):
    """Phase 8 [stereo]: SGM (ops/stereo.py) at 752x480 with 128
    disparities on a seeded textured pair: the plain twin on the card
    against the CPU (the aggregated costs are integers: equal everywhere,
    so are the integer disparities; the subpixel term within
    STEREO_SUBPIX_TOL); the kernel route (sgm_disparity on the card,
    csrc/sgm.cu) against the twin on the card, integer and subpixel
    disparities equal bit for bit; each route's ms a frame by CUDA events
    and the host's enqueue time, and the kernels' launches a call; then a
    10-frame
    rectified pair sequence through the stereo tracker (SGM on the card)
    and a mapper with sensor_type="stereo", whose inactive-geometry
    densify runs SGM on each keyframe's pair."""
    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.ops import stereo as S
    from legslam_torch.ops.cuda import sgm as sgm_kernels
    from legslam_torch.slam import tracking as T
    t0 = time.perf_counter()
    left, right = textured_pair(STEREO_SHAPE, 40, seed=0)
    lc, rc = (torch.as_tensor(x, device=dev) for x in (left, right))
    agg_card = S.sgm_aggregate(lc, rc, STEREO_DISP)
    disp_card = S.disparity_from_aggregate(agg_card, STEREO_DISP, 8).cpu()
    agg_cpu = S.sgm_aggregate(torch.as_tensor(left), torch.as_tensor(right),
                              STEREO_DISP)
    disp_cpu = S.disparity_from_aggregate(agg_cpu, STEREO_DISP, 8)
    agg_equal = torch.equal(agg_card.cpu(), agg_cpu)
    int_equal = torch.equal(agg_card.argmin(-1).cpu(), agg_cpu.argmin(-1))
    sub_err = float((disp_card - disp_cpu).abs().max())
    valid = float((disp_card > 0).float().mean())
    med = float(disp_card[disp_card > 0].median()) if valid else -1.0
    del agg_card, agg_cpu
    # the kernel route against the twin on the card, bit for bit
    n0 = sgm_kernels.sgm.launches
    disp_kernel = S.sgm_disparity(lc, rc, STEREO_DISP).cpu()
    kernel_launches = sgm_kernels.sgm.launches - n0
    kernel_int = torch.equal(disp_kernel > 0, disp_card > 0) and \
        torch.equal(disp_kernel.round(), disp_card.round())
    kernel_bits = torch.equal(disp_kernel.view(torch.int32),
                              disp_card.view(torch.int32))
    ms, host_ms = per_call_ms(lambda: S.sgm_disparity(lc, rc, STEREO_DISP),
                              20, warmup=3)
    twin_ms, twin_host_ms = per_call_ms(
        lambda: S.disparity_from_aggregate(
            S.sgm_aggregate(lc, rc, STEREO_DISP), STEREO_DISP, 8), 3,
        warmup=1)
    h, w = STEREO_SHAPE
    steps = max(h, w) - 1
    print(f"[stereo] SGM {w}x{h}, {STEREO_DISP} disparities, textured pair "
          f"at disparity 40: twin card vs CPU aggregated costs equal "
          f"{agg_equal}, integer disparities equal {int_equal}, subpixel "
          f"max abs err {sub_err:.3g} (tol {STEREO_SUBPIX_TOL}); valid "
          f"{valid:.2%}, median disparity {med:.3f}; kernel route vs twin on "
          f"the card: integer disparities equal {kernel_int}, bit for bit "
          f"{kernel_bits}; kernels {ms:.4f} ms a frame (CUDA events), host "
          f"enqueue {host_ms:.3f} ms, {kernel_launches} launches a call; "
          f"twin {twin_ms:.2f} ms (CUDA events), host {twin_host_ms:.2f} ms, "
          f"its scan {steps} steps of {2 * h + 2 * w} sequences x "
          f"{STEREO_DISP} [{card}]")
    if not kernel_bits:
        fails.append("stereo: the SGM kernels' disparity differs from the "
                     "twin's")
    if not 1 <= kernel_launches <= 6:
        fails.append(f"stereo: {kernel_launches} SGM kernel launches a call")
    if not agg_equal:
        fails.append("stereo: card and CPU SGM costs differ")
    if not int_equal:
        fails.append("stereo: card and CPU integer disparities differ")
    if not sub_err <= STEREO_SUBPIX_TOL:
        fails.append(f"stereo: subpixel error {sub_err:.3g} > "
                     f"{STEREO_SUBPIX_TOL}")
    if not abs(med - 40) < 1.0:
        fails.append(f"stereo: median disparity {med:.3f} not 40 +- 1")
    secs = {"sgm": time.perf_counter() - t0}

    # the stereo tracker and mapper over a rectified pair sequence
    t0 = time.perf_counter()
    ds = SyntheticDataset(**STEREO_ROOM, device=dev)
    fx = ds.intrinsics["fx"]
    seq = []
    for i in range(len(ds)):
        f = ds.read(i)
        seq.append((hide_gt(f, depth=None),
                    right_view(f.color, f.depth, fx, STEREO_BASELINE), f.c2w))
    secs["render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    intr = dict(ds.intrinsics, stereo_baseline=STEREO_BASELINE)
    fe = T.TrackingFrontend(intr, sensor="stereo",
                            stereo_baseline=STEREO_BASELINE, max_corners=300,
                            kf_trans_th=0.05, kf_rot_deg_th=5.0, device=dev)
    mapper = GaussianMapper(
        fe.queue, intr, mp=MapperParams(min_num_initial_map_kfs=2,
                                        depth_cache=1),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16"),
        capacity=1 << 18, result_dir=out_dir, sensor_type="stereo",
        device=dev)
    densified = []
    stereo_geo = mapper._stereo_inactive_geometry

    def counted_geo(kf, packet):
        out = stereo_geo(kf, packet)
        densified.append(0 if out[0] is None else len(out[0]))
        return out
    mapper._stereo_inactive_geometry = counted_geo
    track_ms = []
    for fr, right, _ in seq:
        ta = time.perf_counter()
        fe.track(fr, color_right=right)
        track_ms.append((time.perf_counter() - ta) * 1e3)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            mapper.train_iteration()
    sync(dev)
    # the drift bound of tests/test_tracking_stereo.py:49-80: translation
    # relative to the first frame, against GT, well under the span
    T0 = fe.poses[0]
    G0 = seq[0][2]
    errs = [np.linalg.norm((np.linalg.inv(T0) @ est)[:3, 3] -
                           (np.linalg.inv(G0) @ seq[fid][2])[:3, 3])
            for fid, est in fe.poses.items()]
    span = float(np.linalg.norm(seq[-1][2][:3, 3] - seq[0][2][:3, 3]))
    bound = max(0.5 * span, 0.15)
    secs["sequence"] = time.perf_counter() - t0
    print(f"[stereo] sequence: {len(seq)} rectified pairs "
          f"{ds.intrinsics['width']}x{ds.intrinsics['height']} (baseline "
          f"{STEREO_BASELINE} m), stereo tracker with SGM on the card: "
          f"{fe.n_keyframes_created} keyframes, lost {fe.lost_frames}, "
          f"median drift {np.median(errs):.4f} m (bound {bound:.4f} m, "
          f"span {span:.4f} m); tracker ms a frame median "
          f"{statistics.median(track_ms):.2f}; mapper sensor_type stereo: "
          f"SGM densify points a keyframe {densified}, {mapper.iteration} "
          f"iterations, num_valid "
          f"{int(mapper.state.num_valid()) if mapper.state else 0}; seconds "
          f"{({k: round(v, 1) for k, v in secs.items()})} [{card}]")
    if fe.n_keyframes_created < 2:
        fails.append(f"stereo: {fe.n_keyframes_created} keyframes < 2")
    if not np.median(errs) < bound:
        fails.append(f"stereo: median drift {np.median(errs):.4f} >= "
                     f"{bound:.4f}")
    if not sum(densified) > 0:
        fails.append("stereo: the SGM densify added no points")


def mono_phase(dev, card, fails, out_dir):
    """Phase 8 [mono]: 24 frames at 640x480 through the monocular tracker
    (depth kept for its scale borrowing, as in
    tests/test_tracking_mono.py:112-134) and a mapper with
    sensor_type="monocular". Gates: the map initializes, >= 3 keyframes,
    a SCALE_REFINEMENT emitted and applied, the up-to-scale ATE bound of
    test_mono_tracking_ate_up_to_scale."""
    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam import tracking as T
    t0 = time.perf_counter()
    ds = SyntheticDataset(**MONO_ROOM, device=dev)
    frames = [ds.read(i) for i in range(len(ds))]
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = T.TrackingFrontend(ds.intrinsics, sensor="mono", scale_refine_kfs=2,
                            device=dev)
    mapper = GaussianMapper(
        fe.queue, ds.intrinsics, mp=MapperParams(min_num_initial_map_kfs=2),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16"),
        capacity=1 << 18, result_dir=out_dir, sensor_type="monocular",
        device=dev)
    ops = OpCounter(mapper)
    emitted = []
    push = fe.queue.push

    def counted_push(op):
        emitted.append(op.kind.name)
        return push(op)
    fe.queue.push = counted_push
    track_ms = []
    for f in frames:
        ta = time.perf_counter()
        fe.track(hide_gt(f))
        track_ms.append((time.perf_counter() - ta) * 1e3)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            mapper.train_iteration()
    sync(dev)
    ate_s, ate_r = traj_ate(fe, frames)
    n_sr = emitted.count("SCALE_REFINEMENT")
    print(f"[mono] {len(frames)} frames {ds.intrinsics['width']}x"
          f"{ds.intrinsics['height']} of {MONO_ROOM['n_gaussians']} gaussians"
          f", monocular tracker (depth only for the scale borrow): "
          f"initialized {fe.initialized}, {fe.num_keyframes} keyframes, "
          f"lost {fe.lost_frames}, SCALE_REFINEMENT emitted {n_sr} applied "
          f"{ops.kinds.get('SCALE_REFINEMENT', 0)}, mono scale "
          f"{fe.mono_scale:.4f}; ATE Sim(3) {ate_s:.4f} m (gate < "
          f"{MONO_ATE_SIM3}), unaligned {ate_r:.4f} m; tracker ms a frame "
          f"median {statistics.median(track_ms):.2f}; mapper monocular: "
          f"map initialized {mapper.state is not None}, {mapper.iteration} "
          f"iterations; seconds render {render_s:.1f} run "
          f"{time.perf_counter() - t0:.1f} [{card}]")
    if not fe.initialized or mapper.state is None:
        fails.append("mono: the map did not initialize")
    if fe.num_keyframes < 3:
        fails.append(f"mono: {fe.num_keyframes} keyframes < 3")
    if n_sr < 1 or ops.kinds.get("SCALE_REFINEMENT", 0) < 1:
        fails.append(f"mono: SCALE_REFINEMENT emitted {n_sr}, applied "
                     f"{ops.kinds.get('SCALE_REFINEMENT', 0)}")
    if not ate_s < MONO_ATE_SIM3:
        fails.append(f"mono: Sim(3) ATE {ate_s:.4f} >= {MONO_ATE_SIM3}")


def viewer_phase(dev, card, fails, fe, mapper):
    """Phase 8 [viewer]: serving/viewer.ViewerServer on [visual]'s mapper
    and frontend on a local ephemeral port: /state and POST /params
    answer; the /render query's RGB equals a direct render_from_pose of
    the same pose bit for bit; the /slam_frame pane's input holds the
    tracker's keypoints; the JPEG routes answer (200 with cv2, else 500
    saying cv2 is missing)."""
    import threading
    import urllib.error
    import urllib.request

    from legslam_torch.serving import viewer as V
    v = V.ViewerServer(mapper=mapper, frontend=fe, host="127.0.0.1", port=0,
                       device=dev)
    server = v.serve()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        state, _ = _http(base + "/state")
        params, _ = _http(base + "/params", {"lambda_dssim": 0.25})
        # an orbit whose camera sits at the newest keyframe and looks
        # along its axis, so the render shows the mapped walls
        kf = mapper.keyframes[max(mapper.keyframes)]
        fwd = kf.R[2].astype(np.float64)          # camera z in the world
        eye = -(kf.R.T @ kf.t)
        center = eye + 2.0 * fwd
        q = dict(yaw=str(math.atan2(-fwd[0], -fwd[2])),
                 pitch=str(math.asin(-fwd[1])), r="2.0",
                 cx=str(center[0]), cy=str(center[1]), cz=str(center[2]),
                 w="640", h="360")
        rgb = v.render_rgb(q)
        R, t, w, h = V.query_pose(q)
        direct = mapper.render_from_pose(R, t, w, h).color.float().cpu() \
            .numpy()
        render_equal = bool(np.array_equal(rgb, direct))
        vis = v.slam_frame_input()
        kp_equal = vis is not None and np.array_equal(vis["pts"],
                                                      fe._track_px)
        jpeg = V.jpeg_available()
        codes = {}
        for route in ("/render?w=320&h=180", "/slam_frame"):
            try:
                with urllib.request.urlopen(base + route, timeout=60) as r:
                    codes[route] = (r.status, r.read()[:2] == b"\xff\xd8")
            except urllib.error.HTTPError as e:
                codes[route] = (e.code, "cv2" in e.read().decode())
        secs = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    print(f"[viewer] /state {state}; POST /params {params}; /render RGB "
          f"640x360 equals render_from_pose: {render_equal} (mean "
          f"{float(rgb.mean()):.4f}); /slam_frame input keypoints "
          f"{0 if vis is None else len(vis['pts'])} equal the tracker's: "
          f"{kp_equal}; JPEG encoding available: {jpeg}; JPEG routes "
          f"(status, {'JPEG magic' if jpeg else 'message names cv2'}) "
          f"{codes}; seconds {secs:.1f} [{card}]")
    if state.get("iteration") != mapper.iteration:
        fails.append(f"viewer: /state answered {state}")
    if params.get("updated") != ["lambda_dssim"] or \
            mapper.opt.lambda_dssim != 0.25:
        fails.append(f"viewer: POST /params answered {params}")
    if not render_equal:
        fails.append("viewer: /render RGB differs from render_from_pose")
    if not kp_equal:
        fails.append("viewer: /slam_frame input lacks the tracker's keypoints")
    want = 200 if jpeg else 500
    for route, (code, ok) in codes.items():
        if code != want or not ok:
            fails.append(f"viewer: {route} answered {code}")


# --- phase 9: the bucketed layout, strips, views, slabs and the cull ------

BUCKETS = 4
STRIPS = 4


def bucket_cfg(cfg, n_buckets=BUCKETS, share=2):
    """cfg in the bucketed layout: n_buckets buckets of `share` x the even
    split of max_pairs each. An even split loses pairs: the rank blocks
    hold their pairs unevenly (bucket_phase prints the split)."""
    import dataclasses
    return dataclasses.replace(
        cfg, n_buckets=n_buckets,
        bucket_cap=share * cfg.max_pairs // n_buckets)


@torch.no_grad()
def render_view(st, view, gt, cfg, **kw):
    """The main path's render (no gradient) of the store from the view."""
    from legslam_torch.ops.rasterize import render_arrays
    return render_arrays(
        st.params.xyz, st.sh(), st.params.lang_feat, st.opacities(),
        st.scales(), st.params.rotation, st.valid, view.world_view,
        view.full_proj, view.cam_center, view.tan_fovx, view.tan_fovy,
        view.width, view.height, gt["bg"], 3, cfg, **kw)


def renders_close(a, b, label, fails) -> float:
    """Two renders at the forward tolerances (colour, depth and t_final
    atol 3e-5 / rtol 1e-3, LF 2e-4); returns the largest error."""
    res = {n: close(getattr(a, n), getattr(b, n), 3e-5, 1e-3)
           for n in ("color", "depth", "final_t")}
    res["lf"] = close(a.lang_feat, b.lang_feat, 2e-4, 1e-3)
    for n, (e, ok) in res.items():
        if not ok:
            fails.append(f"{label}: {n} outside tolerance (max|err| {e:.3g})")
    return max(e for e, _ in res.values())


def bucket_phase(dev, card, fails, st0, view, gt):
    """[buckets]: phase 4's scene (st0, the initial store) in the bucketed
    layout, n_buckets 4 of 2^19 pairs (bucket_cfg's share 2: an even
    split of the flat max_pairs, 4 of 2^18, loses pairs, and the phase
    prints how many). Gates: no pair lost to a bucket cap; each bucketed kernel against its plain
    version at phase 3's size and on the first step's inputs at 1200x680
    (check_kernels' tolerances); the bucketed render against the flat one
    at the forward tolerances; 8 steps of the bucketed main path (binning
    refreshed every 8, no trims: kfin is the flat layout's) launch each
    kernel once a step. Prints the kernels' CUDA-event times beside the
    flat layout's on the same store (fresh binnings, timed in turns),
    their bounds from the bucketed pair arrays, the plain versions' times
    and the two binnings' times."""
    from legslam_torch.models import gaussians as G
    from legslam_torch.ops.cuda import composite as cf
    from legslam_torch.ops.cuda import composite_bwd as cb
    out = {}
    st3, view3, gt3 = make_scene(dev, 320, 192, 20_000, 1 << 15, seed=1)
    for mm in ("float32", "bfloat16"):
        drv = StepLoop(G.copy_state(st3), view3, gt3,
                       bucket_cfg(make_cfg(1 << 16, mm)))
        binning = drv._binning()
        fa, ba = capture_kernel_inputs(lambda: drv.step(binning))
        check_kernels(fa, ba, f"buckets 320x192 {mm}", card, fails)
    del st3, view3, gt3, drv

    flat_cfg = make_cfg(1 << 20, "bfloat16")
    bcfg = bucket_cfg(flat_cfg)
    drv_b = StepLoop(G.copy_state(st0), view, gt, bcfg)
    bin_b = drv_b._binning()
    lost = int(bin_b[1])
    split = bin_b[0].tile_count.sum(0).tolist()
    even = StepLoop(st0, view, gt, bucket_cfg(flat_cfg, share=1))._binning()
    lost_even = int(even[1])
    del even
    fa_b, ba_b = capture_kernel_inputs(lambda: drv_b.step(bin_b))
    out["errs"] = check_kernels(fa_b, ba_b, "buckets 1200x680 bf16", card,
                                fails)
    drv_f = StepLoop(G.copy_state(st0), view, gt, flat_cfg)
    fa_f, ba_f = capture_kernel_inputs(lambda: drv_f.step(drv_f._binning()))
    e_render = renders_close(render_view(st0, view, gt, bcfg),
                             render_view(st0, view, gt, flat_cfg),
                             "buckets render", fails)
    _, _, kfin_f = cf.composite_forward(*fa_f)
    b_b, b_f = bounds(fa_b, None), bounds(fa_f, kfin_f)
    with ClockSampler() as clk:
        t = {}
        t["fwd"], t["fwd_flat"] = turns_ms(
            lambda: cf.composite_forward(*fa_b),
            lambda: cf.composite_forward(*fa_f), 20)
        t["bwd"], t["bwd_flat"] = turns_ms(
            lambda: cb.composite_backward(*ba_b),
            lambda: cb.composite_backward(*ba_f), 10)
        t["binning"], t["binning_flat"] = turns_ms(
            drv_b._binning, drv_f._binning, 5)
    t["fwd_plain"] = event_ms(lambda: cf.composite_forward_plain(*fa_b), 2)
    t["bwd_plain"] = event_ms(lambda: cb.composite_backward_plain(*ba_b), 2)
    del drv_f, fa_f, ba_f

    # the bucketed main path: one refresh group of 8 steps
    loop = StepLoop(G.copy_state(st0), view, gt, bcfg)
    for fn in (cf.composite_forward, cb.composite_backward):
        fn.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    binning = loop._binning()
    losses = [float(loop.step(binning).loss) for _ in range(loop.refresh)]
    group_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fwd=cf.composite_forward.launches,
                    bwd=cb.composite_backward.launches)
    print(f"[buckets] 1200x680, 200k gaussians, bf16, {BUCKETS} buckets of "
          f"{bcfg.bucket_cap} pairs ({fa_b[2].shape[0]} pair rows, "
          f"{int(bin_b[0].num_rendered)} valid, {lost} lost to the caps; "
          f"pairs a bucket {split}; buckets of {flat_cfg.max_pairs // BUCKETS}"
          f" would lose {lost_even}); "
          f"bucketed render vs flat max|err| {e_render:.3g}; kernel times "
          f"(fresh binnings, same store, in turns): fwd {t['fwd']:.3f} ms "
          f"(flat {t['fwd_flat']:.3f}; plain {t['fwd_plain']:.3f}; bound "
          f"{b_b['fwd']['bound_ms']:.3f} by {b_b['fwd']['bound_by']}, flat's "
          f"{b_f['fwd']['bound_ms']:.3f}), bwd {t['bwd']:.3f} ms (flat "
          f"{t['bwd_flat']:.3f}; plain {t['bwd_plain']:.3f}; bound "
          f"{b_b['bwd']['bound_ms']:.3f} by {b_b['bwd']['bound_by']}, flat's "
          f"{b_f['bwd']['bound_ms']:.3f}); work {b_b['counts']} (flat "
          f"{b_f['counts']}); binning {t['binning']:.3f} ms (flat "
          f"{t['binning_flat']:.3f}); 8 bucketed steps {group_ms:.1f} ms, "
          f"losses {[round(x, 5) for x in losses[::3]]}, launches "
          f"{launches} [{card}]")
    print(f"[clocks] buckets timing: {clk.summary()} [{card}]")
    if lost:
        fails.append(f"buckets: {lost} pairs lost to the bucket caps")
    if not all(math.isfinite(x) for x in losses):
        fails.append("buckets: loss not finite")
    for k, v in launches.items():
        if v != loop.refresh:
            fails.append(f"buckets: {k} launched {v} times in "
                         f"{loop.refresh} steps")
    out.update(times=t, bounds=b_b, launches=launches)
    return out


def one_step(st, view, gt, cfg, step_fn=None, **kw):
    """One main-path train_step (or step_fn with its own targets) on a
    copy of st; returns (store, aux). From the initial store, Adam's
    first step moves each parameter by lr * sign(g): the gradients' float
    atomics leave it as it is unless a gradient sits at rounding noise
    (two train_steps there agree to 1e-6 on the H100; a store trained a
    few steps has rotation moments ~6e-8 whose updates the same noise
    moves by up to 3e-4)."""
    from legslam_torch.config import OptimizationParams
    from legslam_torch.mapper.train_step import train_step
    from legslam_torch.models import gaussians as G
    st = G.copy_state(st)
    if step_fn is not None:
        return step_fn(st)
    return train_step(
        st, view.world_view, view.full_proj, view.cam_center, view.tan_fovx,
        view.tan_fovy, gt["gt_color"], gt["gt_lang_feat"], gt["gt_depth"],
        gt["mask"], gt["bg"], 9.0, 1.0, width=view.width,
        height=view.height, active_sh_degree=3, opt=OptimizationParams(),
        cfg=cfg, max_per_tile=2048, **kw)


# a step against train_step: the parameters absolutely
# (tests/test_spatial.py:96); the Adam moments ((1 - beta1) * g after the
# first step, so the gradients' scale shows, which the sign-only first
# update hides) and the densify grad_accum relative to their group's
# largest value. Two train_steps on the H100 differ by up to 3.5e-5 of
# that in the LF moments, a 1-view batched tick by 5.6e-4 (float
# atomics); a strip's H_pad/H rescale left out would be 3.5e-2.
STEP_ATOL, STEP_RTOL = 5e-5, 4e-3


def step_errs(a, b) -> dict:
    """Largest errors of store a against b after one step: 'params'
    absolute, 'adam_m' and 'grad_accum' relative to b's largest |value|
    (the worst group for the moments)."""
    from legslam_torch.models import gaussians as G

    def rel(x, y):
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
    return dict(
        params=max(float((getattr(a.params, n) - getattr(b.params, n))
                         .abs().max()) for n in G.GROUPS),
        adam_m=max(rel(getattr(a.adam_m, n), getattr(b.adam_m, n))
                   for n in G.GROUPS),
        grad_accum=rel(a.stats.grad_accum, b.stats.grad_accum))


def step_ok(errs, l_a, l_b) -> bool:
    """errs (step_errs) and the two losses within the step tolerances:
    loss rtol 1e-6, STEP_ATOL on the parameters, STEP_RTOL on the rest."""
    return (abs(l_a - l_b) <= 1e-6 * abs(l_b)
            and errs["params"] <= STEP_ATOL
            and errs["adam_m"] <= STEP_RTOL
            and errs["grad_accum"] <= STEP_RTOL)


def errs_text(errs) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())


def mapper_run(dev, card, fails, label, ds, frames, out_dir, p_slabs=0,
               **mapper_kw):
    """Phase 5's room through GaussianMapper with mapper_kw (phase 5's
    schedule and config, with cfg.p_slabs = p_slabs). Gate: keyframe PSNR
    3 dB over the initial map's,
    every kernel launched. Returns (mapper, ms per tick, launches)."""
    from legslam_torch.config import RasterizeConfig
    kernels = path_kernels()
    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16", cuda_sort=True,
                          p_slabs=p_slabs)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with ClockSampler() as clk:
        mapper, init, iter_ms, losses, _ = drive_mapper(
            dev, ds, frames, cfg, out_dir, **mapper_kw)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    psnr = mapper.record_keyframe_metrics("experiment")["psnr"]
    psnr_init = keyframe_psnr(mapper, init)
    ms = statistics.median(iter_ms)
    print(f"[{label}] mapper {mapper_kw} p_slabs {p_slabs} over phase 5's "
          f"{len(frames)} "
          f"frames: {mapper.iteration} ticks, {len(mapper.keyframes)} "
          f"keyframes, num_valid {int(mapper.state.num_valid())}, capacity "
          f"{mapper.state.capacity}; ms a tick median {ms:.2f} p90 "
          f"{sorted(iter_ms)[int(0.9 * (len(iter_ms) - 1))]:.2f}; fresh "
          f"binnings {mapper.fresh_binnings}; launches {launches}; peak "
          f"memory {peak:.2f} GiB; keyframe PSNR {psnr:.2f} dB (initial map "
          f"{psnr_init:.2f}) [{card}]")
    print(f"[clocks] {label} mapper: {clk.summary()} [{card}]")
    if not psnr >= psnr_init + 3.0:
        fails.append(f"{label}: PSNR {psnr:.2f} not 3 dB above the initial "
                     f"map's {psnr_init:.2f}")
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"{label}: loss not finite")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"{label}: {k} launched no time")
    return mapper, ms, launches, peak


def strips_phase(dev, card, fails, st0, view, gt, ds, frames, out_dir):
    """[strips]: the main-path step in STRIPS tile-row strips
    (parallel/spatial.py; 43 tile rows -> strips of 176 rows, padded to
    704). Gates: the full render drops no pair to the span cap; each
    strip's colour and depth equal the full render's rows to 1e-6
    (tests/test_spatial.py's atol; t_final's bit equality is printed);
    one step from the initial store st0 agrees with train_step's on the
    same view (step_ok: the loss, the parameters, the Adam moments and
    grad_accum), with the same visit counts. Then phase 5's room through
    GaussianMapper(spatial_strips=4)."""
    from legslam_torch.parallel import spatial
    from legslam_torch.ops.rasterize import compute_binning
    cfg = make_cfg(1 << 20, "bfloat16")
    layout = spatial.spatial_layout(view.height, cfg.tile_h, STRIPS)
    p = st0.params
    span_ov = int(compute_binning(
        p.xyz, st0.scales(), p.rotation, st0.valid, view.world_view,
        view.full_proj, view.tan_fovx, view.tan_fovy, view.width,
        view.height, cfg, opacity=st0.opacities())[0].span_overflow)
    full = render_view(st0, view, gt, cfg)
    cys = spatial.strip_offsets(layout)
    e_c = e_d = 0.0
    t_equal = True
    for cy in cys:
        o = render_view(st0, view, gt, cfg, crop_y=float(cy),
                        crop_h=layout.h_local)
        rows = slice(int(cy), min(int(cy) + layout.h_local, view.height))
        n = rows.stop - rows.start
        e_c = max(e_c, float((o.color[:n] - full.color[rows]).abs().max()))
        e_d = max(e_d, float((o.depth[:n] - full.depth[rows]).abs().max()))
        t_equal &= torch.equal(o.final_t[:n], full.final_t[rows])

    def strip_step(st):
        pads = [spatial.pad_rows(gt[k], layout.h_padded) for k in
                ("gt_color", "gt_lang_feat", "gt_depth", "mask")]
        from legslam_torch.config import OptimizationParams
        return spatial.spatial_train_step(
            st, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, *pads, gt["bg"], 9.0, 1.0, cys,
            width=view.width, height=view.height, h_local=layout.h_local,
            active_sh_degree=3, opt=OptimizationParams(), cfg=cfg,
            max_per_tile=2048)
    sync(dev)
    t0 = time.perf_counter()
    st_s, aux_s = one_step(st0, view, gt, cfg, strip_step)
    sync(dev)
    strip_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    st_1, aux_1 = one_step(st0, view, gt, cfg)
    sync(dev)
    one_ms = (time.perf_counter() - t0) * 1e3
    errs = step_errs(st_s, st_1)
    denom_eq = torch.equal(st_s.stats.denom, st_1.stats.denom)
    l_s, l_1 = float(aux_s.loss), float(aux_1.loss)
    print(f"[strips] {STRIPS} strips of {layout.h_local} rows (padded "
          f"{layout.h_padded}), span_overflow {span_ov}: strips vs the full "
          f"render's rows max|err| colour {e_c:.3g} depth {e_d:.3g}, "
          f"t_final bit-equal {t_equal}; one step from the initial store: "
          f"loss {l_s:.7f} (train_step {l_1:.7f}), max err "
          f"{errs_text(errs)}, denom equal {denom_eq}; step "
          f"ms strips {strip_ms:.1f} vs one view {one_ms:.1f} (one call "
          f"each, host clock) [{card}]")
    if span_ov:
        fails.append(f"strips: span_overflow {span_ov}")
    if not (e_c <= 1e-6 and e_d <= 1e-6):
        fails.append(f"strips: strip rows differ from the full render "
                     f"(colour {e_c:.3g}, depth {e_d:.3g})")
    if not (step_ok(errs, l_s, l_1) and denom_eq):
        fails.append(f"strips: step differs from train_step (loss {l_s:.7f}"
                     f" vs {l_1:.7f}, {errs_text(errs)}, denom equal "
                     f"{denom_eq})")
    del st_s, st_1
    _, ms, launches, _ = mapper_run(dev, card, fails, "strips", ds, frames,
                                    out_dir, spatial_strips=STRIPS)
    return ms, launches


def multiview_phase(dev, card, fails, st0, view, gt, ds, frames, out_dir):
    """[multiview]: a batched tick of one view (parallel/sharded.py) on
    the initial store against train_step on the same view (step_ok: the
    loss, the parameters, the Adam moments and grad_accum; the same visit
    counts: tests/test_mapper_multiview.py:68); then phase 5's room through
    GaussianMapper(n_views=4), its ms a tick and a view and its peak
    memory."""
    from legslam_torch.config import OptimizationParams
    from legslam_torch.parallel import sharded
    cfg = make_cfg(1 << 20, "bfloat16")

    def batched(st):
        batch = sharded.make_view_batch(
            [view], gt["gt_color"][None], gt["gt_lang_feat"][None],
            gt["gt_depth"][None], gt["mask"][None])
        return sharded.batched_train_step(
            st, batch, gt["bg"], 9.0, 1.0, width=view.width,
            height=view.height, active_sh_degree=3,
            opt=OptimizationParams(), cfg=cfg, max_per_tile=2048)
    st_b, aux_b = one_step(st0, view, gt, cfg, batched)
    st_1, aux_1 = one_step(st0, view, gt, cfg)
    errs = step_errs(st_b, st_1)
    denom_eq = torch.equal(st_b.stats.denom, st_1.stats.denom)
    l_b, l_1 = float(aux_b.loss), float(aux_1.loss)
    print(f"[multiview] a batched tick of 1 view vs train_step on the "
          f"initial store: loss {l_b:.7f} vs {l_1:.7f}, max err "
          f"{errs_text(errs)}, denom equal {denom_eq} [{card}]")
    if not (step_ok(errs, l_b, l_1) and denom_eq):
        fails.append(f"multiview: the 1-view batched tick differs from "
                     f"train_step (loss {l_b:.7f} vs {l_1:.7f}, "
                     f"{errs_text(errs)}, denom equal {denom_eq})")
    del st_b, st_1
    n = 4
    mapper, ms, launches, peak = mapper_run(dev, card, fails, "multiview",
                                            ds, frames, out_dir, n_views=n)
    print(f"[multiview] {n} views a tick: {ms:.2f} ms a tick, "
          f"{ms / n:.2f} ms a view, peak {peak:.2f} GiB [{card}]")
    for k in ("composite_fwd", "composite_bwd"):
        if launches[k] != n * mapper.iteration:
            fails.append(f"multiview: {k} launched {launches[k]} times in "
                         f"{mapper.iteration} ticks of {n} views")
    return ms, launches


def step_ms(st, view, gt, cfg, steps=6, **kw) -> float:
    """Median host ms of main-path train_steps with fresh binnings (kw to
    train_step), each ending in a synchronise; the first is a warm-up."""
    from legslam_torch.config import OptimizationParams
    from legslam_torch.mapper.train_step import train_step
    from legslam_torch.models import gaussians as G
    st = G.copy_state(st)
    ms = []
    for i in range(steps):
        sync(st.valid.device)
        t0 = time.perf_counter()
        st, _ = train_step(
            st, view.world_view, view.full_proj, view.cam_center,
            view.tan_fovx, view.tan_fovy, gt["gt_color"], gt["gt_lang_feat"],
            gt["gt_depth"], gt["mask"], gt["bg"], float(i + 1), 1.0,
            width=view.width, height=view.height, active_sh_degree=3,
            opt=OptimizationParams(), cfg=cfg, max_per_tile=2048, **kw)
        sync(st.valid.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[1:])


def slabs_cull_phase(dev, card, fails, st0, view, gt, ds, frames, out_dir):
    """[slabs], [cull]: the main path's forward with p_slabs=8 equals
    p_slabs=0 bit for bit (the prologue runs on 7 of 8 slabs: 200k live
    rows of 262144); with ellipse_cull=False it equals the culled render
    at the forward tolerances and bins more pairs. Each one's step time
    beside the default's (fresh binnings, in turns). Then phase 5's room
    through GaussianMapper with p_slabs=8 (mapper_run's gates), and more
    ticks of that mapper in turns: the watermark from its bookkeeping (one
    host read a store surgery), and read on the host every step
    (train_step's route without a hint); ms a tick of each."""
    import dataclasses

    from legslam_torch.ops.slabs import prefix_rows, watermark
    cfg = make_cfg(1 << 20, "bfloat16")
    slab = dataclasses.replace(cfg, p_slabs=8)
    nocull = dataclasses.replace(cfg, ellipse_cull=False)
    base = render_view(st0, view, gt, cfg)
    o_s = render_view(st0, view, gt, slab)
    same = all(torch.equal(getattr(o_s, n), getattr(base, n)) for n in
               ("color", "depth", "final_t", "lang_feat", "radii"))
    rows = prefix_rows(watermark(st0.valid), st0.capacity, 8)
    o_c = render_view(st0, view, gt, nocull)
    e_c = renders_close(o_c, base, "cull", fails)
    n_cull, n_all = int(base.num_rendered), int(o_c.num_rendered)
    hint = int(watermark(st0.valid))
    with ClockSampler() as clk:
        ms = dict(default=[step_ms(st0, view, gt, cfg)])
        ms["p_slabs"] = step_ms(st0, view, gt, slab, watermark_hint=hint)
        ms["no_cull"] = step_ms(st0, view, gt, nocull)
        ms["default"].append(step_ms(st0, view, gt, cfg))
    print(f"[slabs] p_slabs 8: the prologue, Adam and the statistics on "
          f"{rows} of {st0.capacity} rows; forward equal to p_slabs 0 bit "
          f"for bit: {same}; step ms (fresh binnings, median of 5, in "
          f"turns) {ms['p_slabs']:.2f}, default "
          f"{[round(x, 2) for x in ms['default']]} [{card}]")
    print(f"[cull] ellipse_cull False: {n_all} pairs vs {n_cull} culled; "
          f"render vs culled max|err| {e_c:.3g}; step ms "
          f"{ms['no_cull']:.2f} [{card}]")
    print(f"[clocks] slabs/cull steps: {clk.summary()} [{card}]")
    if not same:
        fails.append("slabs: the p_slabs=8 forward differs from p_slabs=0")
    if not n_all > n_cull:
        fails.append(f"cull: {n_all} pairs without the cull, not more than "
                     f"{n_cull}")
    # the mapper's loop, blocks of ticks with one synchronise at the end
    # (drive_mapper syncs every tick, which would hide a host read)
    mapper = mapper_run(dev, card, fails, "slabs", ds, frames, out_dir,
                        p_slabs=8)[0]
    tick = dict(bookkeeping=[], every_step=[])
    for route in ("bookkeeping", "every_step") * 2 + \
            ("every_step", "bookkeeping") * 2:
        if route == "every_step":
            mapper._watermark = lambda: None   # train_step reads it
        else:
            mapper.__dict__.pop("_watermark", None)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(24):
            mapper.train_iteration()
        sync(dev)
        tick[route].append((time.perf_counter() - t0) * 1e3 / 24)
    mapper.__dict__.pop("_watermark", None)
    print(f"[slabs] mapper p_slabs 8, ms a tick over blocks of 24 ticks "
          f"(one synchronise a block, in turns): watermark from the "
          f"mapper's bookkeeping {[round(x, 3) for x in tick['bookkeeping']]}"
          f", read on the host every step "
          f"{[round(x, 3) for x in tick['every_step']]} [{card}]")
    ms["mapper_tick"] = tick
    return ms


def store_phase(dev, card, fails, ds):
    """shard_store on one card: with no process group the mapper takes
    the one-device path (the whole store), as JAX builds no mesh for one
    device."""
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam.interface import OperationQueue
    m = GaussianMapper(OperationQueue(), ds.intrinsics, shard_store=True,
                       device=dev)
    plain = m._shard_group is None and m._group is None
    print(f"[store] GaussianMapper(shard_store=True) on one card: the "
          f"one-device path (no group): {plain} [{card}]")
    if not plain:
        fails.append("store: shard_store on one card took a group")


# --- phase 10: a capacity rung and loop-closure surgery on the card ---------

# [ladder]: a keyframe every frame, each keypoint with depth a map point,
# the keypoints on the frontend's 16 px grid (its path on a host without
# OpenCV: cv2 finds only ~100 corners in this fog): ~3200 points a
# keyframe, so the initial map of 4 keyframes starts on the ladder's first
# rung, 2^15, and the third keyframe after it takes the store past 60% of
# that, ~20 iterations in, before the first densification (iteration 40)
LADDER_FRONTEND = dict(kf_stride=1, map_point_ratio=1.0)
# [loop]: the loop-closure scene and mapper settings of
# tests/test_torch_mapper_ops.py (one revolution at 5.6 deg a frame)
LOOP_ROOM = dict(n_frames=64, width=160, height=96, n_gaussians=5000,
                 revolutions=1.0, radius=1.0, clutter_ratio=0.0)
LOOP_MP = dict(min_num_initial_map_kfs=3, depth_cache=2,
               do_gaus_pyramid_training=False)
LOOP_TRACK = dict(ransac_thresh=0.1, loop_min_gap=8, cull_redundancy=0.6)
# card against CPU after a surgery, of each group's largest value: four
# float32 ulps (the same elementwise arithmetic on both; measured: 0 on an
# H100)
LOOP_TOL = 4 * 2.0 ** -23


def state_rows_equal(old, new) -> bool:
    """Whether `new` holds `old`'s rows bit for bit below old's capacity:
    parameters, Adam moments, densify statistics, valid flags and
    creation iterations."""
    from legslam_torch.models import gaussians as G
    n = old.capacity
    pairs = [(getattr(getattr(new, g), k), getattr(getattr(old, g), k))
             for g in ("params", "adam_m", "adam_v") for k in G.GROUPS]
    pairs += [(getattr(new.stats, k), getattr(old.stats, k))
              for k in G.STATS]
    pairs += [(new.valid, old.valid), (new.exist_since, old.exist_since)]
    return all(torch.equal(a[:n], b) for a, b in pairs)


def ladder_phase(dev, card, fails, ds, frames, out_dir):
    """Phase 10 [ladder]: phase 5's room, schedule and config through
    GaussianMapper (its capacity ladder on, the default) fed ~3200 map
    points a keyframe (LADDER_FRONTEND, the frontend's keypoint grid), so
    the store starts on the first rung and keyframes' _increase_points
    grow it x4 while training runs. Each grow_capacity is checked as it
    happens (state_rows_equal).
    Gates: a grow inside _increase_points after the first iteration, on
    the card; every grow keeps the old rows bit for bit; no max_pairs
    escalation from the first grow on (a grow raises the pair budget with
    the rung, _ladder_cfg; span escalations follow footprints, which a
    grow leaves alone); finite losses; keyframe PSNR 3 dB over the initial
    map's; every kernel launched."""
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam import trajectory
    kernels = path_kernels()
    grows, grow = [], G.grow_capacity

    def checked_grow(state, new_capacity):
        caller = sys._getframe(1)
        out = grow(state, new_capacity)
        grows.append(dict(
            old=state.capacity, new=new_capacity, by=caller.f_code.co_name,
            iteration=caller.f_locals["self"].iteration,
            device=out.valid.device.type, rows=int(state.num_valid()),
            same=state_rows_equal(state, out)))
        return out

    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16", cuda_sort=True)
    for fn in kernels.values():
        fn.launches = 0
    G.grow_capacity = checked_grow
    has_cv2, trajectory._HAS_CV2 = trajectory._HAS_CV2, False
    try:
        with ClockSampler() as clk:
            mapper, init, iter_ms, losses, rungs = drive_mapper(
                dev, ds, frames, cfg, out_dir, frontend_kw=LADDER_FRONTEND)
    finally:
        G.grow_capacity = grow
        trajectory._HAS_CV2 = has_cv2
    launches = {k: fn.launches for k, fn in kernels.items()}
    psnr = mapper.record_keyframe_metrics("experiment")["psnr"]
    psnr_init = keyframe_psnr(mapper, init)
    by_ingest = [g for g in grows if g["by"] == "_increase_points" and
                 g["iteration"] >= 1 and g["device"] == "cuda"]
    first = min((g["iteration"] for g in grows), default=None)
    late = [e for e in mapper.overflow_escalations if first is not None and
            e[0] >= first and any(c.startswith("max_pairs") for c in e[1])]
    cross = [(cap, iter_ms[i]) for cap, i in rungs.items()
             if i > 0 and i < len(iter_ms)]
    print(f"[ladder] phase 5's room with {LADDER_FRONTEND}: "
          f"{mapper.iteration} iterations, {len(mapper.keyframes)} "
          f"keyframes, num_valid {int(mapper.state.num_valid())}, capacity "
          f"rungs {rungs} (first iteration at each); grows "
          + ", ".join(f"{g['old']}->{g['new']} by {g['by']} at iteration "
                      f"{g['iteration']} ({g['rows']} valid rows, old rows "
                      f"kept bit for bit {g['same']})" for g in grows)
          + f"; ms of the first iteration on each new rung "
          f"{[(c, round(ms, 2)) for c, ms in cross]} against the median "
          f"{statistics.median(iter_ms):.2f} (p90 {pct(iter_ms, 0.9):.2f}); "
          f"escalations {mapper.overflow_escalations}; launches {launches}; "
          f"keyframe PSNR {psnr:.2f} dB (initial map {psnr_init:.2f}) "
          f"[{card}]")
    print(f"[clocks] ladder mapper: {clk.summary()} [{card}]")
    if not by_ingest:
        fails.append(f"ladder: no grow inside _increase_points after the "
                     f"first iteration on the card ({grows})")
    if not all(g["same"] for g in grows):
        fails.append("ladder: a grow changed the rows below the old capacity")
    if late:
        fails.append(f"ladder: max_pairs escalated after the grow {late}")
    if not all(math.isfinite(x) for x in losses):
        fails.append("ladder: loss not finite")
    if not psnr >= psnr_init + 3.0:
        fails.append(f"ladder: PSNR {psnr:.2f} not 3 dB above the initial "
                     f"map's {psnr_init:.2f}")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"ladder: {k} launched no time")
    return launches


class LiveSet:
    """A replaying mapper's source: the tracker's live keyframes after the
    frame being replayed."""

    def __init__(self):
        self.live = set()

    def live_keyframe_ids(self):
        return self.live

    def is_shutdown(self):
        return False


def loop_stream(dev):
    """[loop]'s operations a frame: the RGB-D tracker on the host over
    LOOP_ROOM (rendered on the card, GT hidden), then, as one more frame,
    its loop operation republished as a Sim(3) loop (scale 1.25,
    per-keyframe scales in [0.9, 1.1]) and a SCALE_REFINEMENT the tracker
    builds (_apply_global_scale(1.3)), as tests/test_torch_mapper_ops.py
    replays them. Returns (intrinsics, frontend, [(ops, live set)], the
    tracker's LOOP_CLOSE_BA operations)."""
    import dataclasses

    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.slam import tracking as T
    from legslam_torch.slam.interface import MappingOperation, OpKind
    ds = SyntheticDataset(**LOOP_ROOM, device=dev)
    fe = T.TrackingFrontend(ds.intrinsics, **LOOP_TRACK, device="cpu")
    out = []
    for i in range(len(ds)):
        fe.track(hide_gt(ds.read(i)))
        out.append((list(iter(fe.queue.pop_operation, None)),
                    set(fe.queue.live_keyframe_ids())))
    loops = [o for ops, _ in out for o in ops
             if o.kind == OpKind.LOOP_CLOSE_BA]
    if loops:
        loop, rng = loops[0], np.random.default_rng(0)
        sim3 = dataclasses.replace(loop, scale=1.25, keyframes=[
            dataclasses.replace(p, scale=float(rng.uniform(0.9, 1.1)))
            for p in loop.keyframes])
        fe._apply_global_scale(1.3)
        scale = MappingOperation(
            kind=OpKind.SCALE_REFINEMENT, scale=1.3,
            keyframes=[fe._pose_packet(f) for f in fe._kf_order])
        out.append(([sim3, scale], out[-1][1]))
    return ds.intrinsics, fe, out, len(loops)


def loop_phase(dev, card, fails, out_dir):
    """Phase 10 [loop]: loop_stream's operations replayed, with no
    training between them, by two GaussianMappers with LOOP_MP, one on
    the card and one on the CPU: handle_operation, cull_keyframes against
    the tracker's live set after each frame, initialize_map once its
    conditions hold. After every surgery (LOOP_CLOSE_BA, SCALE_REFINEMENT)
    the two stores are compared. Gates: the tracker closes a loop; the
    same rows valid after every surgery; xyz and the rotation parameters
    within LOOP_TOL of each group's largest value (f32 rounding: the
    surgery is the same arithmetic on both); the surgeries move rows."""
    from legslam_torch.config import MapperParams
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam.interface import OpKind
    t0 = time.perf_counter()
    intr, fe, stream, n_loops = loop_stream(dev)
    track_s = time.perf_counter() - t0
    src = LiveSet()
    card_m, cpu_m = (GaussianMapper(
        src, intr, mp=MapperParams(**LOOP_MP), capacity=1 << 14,
        include_lang_feat=False, seed=0, result_dir=f"{out_dir}_{d}",
        device=d) for d in (dev, "cpu"))
    surgeries, err, same_valid, moved = [], dict(xyz=0.0, rotation=0.0), \
        True, 0
    t0 = time.perf_counter()
    for ops, live in stream:
        for op in ops:
            before = None if cpu_m.state is None else \
                cpu_m.state.params.xyz.clone()
            card_m.handle_operation(op)
            cpu_m.handle_operation(op)
            if op.kind not in (OpKind.LOOP_CLOSE_BA, OpKind.SCALE_REFINEMENT) \
                    or before is None:
                continue
            a, b = card_m.state, cpu_m.state
            same_valid &= torch.equal(a.valid.cpu(), b.valid)
            for k in err:
                x, y = getattr(a.params, k).cpu(), getattr(b.params, k)
                err[k] = max(err[k], float((x - y).abs().max() /
                                           y.abs().max()))
            n = int((b.params.xyz != before).any(1).sum())
            moved += n
            surgeries.append(f"{op.kind.name} scale {op.scale}: {n} rows "
                             f"moved")
        src.live = live
        card_m.cull_keyframes()
        cpu_m.cull_keyframes()
        if card_m.state is None and card_m.has_met_initial_conditions():
            card_m.initialize_map()
            cpu_m.initialize_map()
    replay_s = time.perf_counter() - t0
    n_valid = None if cpu_m.state is None else int(cpu_m.state.num_valid())
    print(f"[loop] RGB-D tracker on the host over {LOOP_ROOM['n_frames']} "
          f"frames {intr['width']}x{intr['height']} (GT hidden): loop "
          f"closures {fe.n_loop_closures} ({n_loops} LOOP_CLOSE_BA), lost "
          f"frames {fe.lost_frames}, {fe.num_keyframes} keyframes live of "
          f"{fe.n_keyframes_created} created, {track_s:.1f} s; the replay on "
          f"the card and the CPU "
          f"({replay_s:.1f} s): {len(surgeries)} surgeries ("
          + "; ".join(surgeries) + f"), num_valid {n_valid}, valid rows "
          f"equal {same_valid}, max |card - CPU| / group max: xyz "
          f"{err['xyz']:.3g}, rotation {err['rotation']:.3g} (tolerance "
          f"{LOOP_TOL:g}) [{card}]")
    if fe.n_loop_closures < 1 or n_loops < 1:
        fails.append("loop: the tracker closed no loop")
    if not surgeries or not moved:
        fails.append(f"loop: no surgery moved a row ({surgeries})")
    if not same_valid:
        fails.append("loop: the card's and the CPU's valid rows differ")
    for k, v in err.items():
        if not v <= LOOP_TOL:
            fails.append(f"loop: {k} {v:.3g} apart, over {LOOP_TOL:g}")


# --- phase 11: the lens-distorted camera and the inertial sensor modes -----

CFG_DIR = Path(__file__).resolve().parent / "cfg"
TUM_CAMERA = "camera/RGB-D/TUM/tum_freiburg1_desk.yaml"
TUM_MAPPER = "gaussian_mapper/RGB-D/TUM/tum_freiburg1_desk.yaml"
# [visual]'s surface room of 40k gaussians, 24 frames at the TUM camera's
# 640x480
UNDISTORT_ROOM = dict(n_frames=24, width=640, height=480,
                      n_gaussians=40_000, seed=3, clutter_ratio=0.0,
                      revolutions=0.15)
# the one cut of the shipped TUM mapper config: 24 frames give 6
# keyframes, so the map starts at the 4th (shipped: 10)
UNDISTORT_MP = dict(min_num_initial_map_kfs=4)
# gates: the valid mask's invalid share (mask < 0.5; TUM fr1's is 5.64%
# on the host), the undistorted keyframe's gain over the raw frame, and
# the keyframe tolerances of tests/test_torch_mapper.py:104-107 for the
# resized sub-levels (color, depth, mask: at most one step, on under 0.5%
# of the values)
INVALID_SHARE = (0.04, 0.08)
UNDISTORT_GAIN = 3.0
KF_STEPS = dict(gt_color=1 / 255, gt_depth=1e-3, mask=1e-6)


def pinhole_sources(intr, iters=20):
    """For each pixel of the camera `intr`, with its dist_coeffs, the
    pixel of the pinhole camera of the same K that it sees: the
    normalized point undistorted by the fixed-point iteration of
    cv2.undistortPoints, projected with K. Returns (map_x, map_y, the
    largest residual in px when the result is distorted back)."""
    from legslam_torch.utils.undistort import distort_normalized
    w, h = int(intr["width"]), int(intr["height"])
    dist = intr["dist_coeffs"]
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xd = (u - intr["cx"]) / intr["fx"]
    yd = (v - intr["cy"]) / intr["fy"]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    xr, yr = distort_normalized(x, y, dist)
    resid = max(float(np.abs(xr - xd).max()) * intr["fx"],
                float(np.abs(yr - yd).max()) * intr["fy"])
    return ((intr["fx"] * x + intr["cx"]).astype(np.float32),
            (intr["fy"] * y + intr["cy"]).astype(np.float32), resid)


def distort_frame(frame, map_x, map_y):
    """`frame` as the distorted camera sees it (pinhole_sources' maps): the
    color sampled bilinearly, the depth from the nearest pixel (a sensor
    reports no blend of two surfaces)."""
    import dataclasses
    from legslam_torch.utils.undistort import remap_bilinear
    h, w = frame.depth.shape
    xi = np.rint(map_x).astype(np.int64)
    yi = np.rint(map_y).astype(np.int64)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    depth = np.where(inside, frame.depth[np.clip(yi, 0, h - 1),
                                         np.clip(xi, 0, w - 1)], 0.0)
    return dataclasses.replace(
        frame, color=remap_bilinear(frame.color, map_x, map_y),
        depth=depth.astype(np.float32))


def keyframes_match(a, b) -> tuple[bool, dict]:
    """Whether mapper a's keyframes equal mapper b's: the full level bit
    for bit; and each field's largest sub-level difference in KF_STEPS
    units and its share of differing values."""
    exact, worst = True, {}
    for fid, kb in b.keyframes.items():
        ka = a.keyframes[fid]
        for name, step in KF_STEPS.items():
            levels = list(zip(getattr(ka, name), getattr(kb, name)))
            for lvl, (x, y) in enumerate(levels):
                x, y = x.cpu().numpy(), y.cpu().numpy()
                if lvl == len(levels) - 1:
                    exact &= bool(np.array_equal(x, y))
                    continue
                d = np.abs(x - y)
                steps, share = worst.get(name, (0.0, 0.0))
                worst[name] = (max(steps, float(d.max()) / step),
                               max(share, float((d > 0).mean())))
    return exact, worst


def undistort_phase(dev, card, fails, out_dir):
    """Phase 11 [undistort]: the shipped TUM fr1 camera (640x480, five
    distortion coefficients) and mapper config through the port's
    loaders; UNDISTORT_ROOM rendered with the camera's pinhole K and
    distorted on the host (pinhole_sources, distort_frame); the GT-pose
    frontend with a keyframe every 4th frame and GaussianMapper on "cuda"
    (bf16, cuda_sort, capacity 2^18, 7 iterations a frame, then the tail),
    which undistorts each keyframe on the host and gates its loss with
    the valid mask.
    Gates: the keyframes equal a CPU mapper's fed the same packets (the
    full level bit for bit, the resized sub-levels within KF_STEPS);
    inside the valid mask the undistorted gt_color is UNDISTORT_GAIN
    times closer (mean abs) to the pinhole render than the raw frame is;
    the mask's invalid share lies in INVALID_SHARE; garbage in the invalid
    region of a keyframe's render leaves its mapping_loss unchanged to
    rtol 1e-6 on the card; the keyframe PSNR inside the mask 3 dB over the
    initial map's; every kernel launched. Returns the launches."""
    import dataclasses
    from legslam_torch.config import RasterizeConfig, load_run_config
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.ops import losses as L
    from legslam_torch.slam.interface import OperationQueue
    from legslam_torch.utils import undistort as U
    opt, mp, intr = load_run_config(str(CFG_DIR / TUM_MAPPER),
                                    str(CFG_DIR / TUM_CAMERA))
    mp = dataclasses.replace(mp, **UNDISTORT_MP)
    t0 = time.perf_counter()
    ds = SyntheticDataset(**UNDISTORT_ROOM, device=dev)
    ds.intrinsics = {k: intr[k]
                     for k in ("width", "height", "fx", "fy", "cx", "cy")}
    pinhole = [ds.read(i) for i in range(len(ds))]
    map_x, map_y, resid = pinhole_sources(intr)
    raw = [distort_frame(f, map_x, map_y) for f in pinhole]
    render_s = time.perf_counter() - t0

    # the packets the mapper ingests, and the host ms of each remap
    packets, remap_ms = [], []
    ingest = GaussianMapper._ingest_keyframe
    remap = U.Undistortion.undistort_image

    def recorded(self, packet):
        if packet.fid not in self.keyframes:
            packets.append(packet)
        return ingest(self, packet)

    def timed(self, img):
        ta = time.perf_counter()
        try:
            return remap(self, img)
        finally:
            remap_ms.append((time.perf_counter() - ta) * 1e3)

    kernels = path_kernels()
    for fn in kernels.values():
        fn.launches = 0
    cfg = RasterizeConfig(backend="cuda", mm_dtype="bfloat16", cuda_sort=True)
    GaussianMapper._ingest_keyframe = recorded
    U.Undistortion.undistort_image = timed
    t0 = time.perf_counter()
    try:
        with ClockSampler() as clk:
            mapper, init, iter_ms, losses, _ = drive_mapper(
                dev, ds, raw, cfg, out_dir, intr=intr, opt=opt, mp=mp)
    finally:
        GaussianMapper._ingest_keyframe = ingest
        U.Undistortion.undistort_image = remap
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    und = mapper.undistortion
    if und is None:
        fails.append("undistort: the mapper built no undistortion for "
                     f"dist_coeffs {intr.get('dist_coeffs')}")
        return launches

    # the same packets through a CPU mapper
    cpu = GaussianMapper(OperationQueue(), intr, opt=opt, mp=mp, cfg=cfg,
                         capacity=1 << 10, result_dir=out_dir + "_cpu",
                         device="cpu")
    for p in packets:
        cpu._ingest_keyframe(p)
    exact, worst = keyframes_match(mapper, cpu)

    # inside the valid mask: the undistorted keyframe against the pinhole
    # render, and the raw frame against it
    keep = und.valid_mask >= 0.999
    mae_und = statistics.mean(
        float(np.abs(kf.gt_color[-1].cpu().numpy()
                     - pinhole[fid].color)[keep].mean())
        for fid, kf in mapper.keyframes.items())
    mae_raw = statistics.mean(
        float(np.abs(raw[fid].color - pinhole[fid].color)[keep].mean())
        for fid in mapper.keyframes)
    invalid = float((und.valid_mask < 0.5).mean())

    # garbage in the invalid region of a keyframe's render, on the card
    kf = mapper.keyframes[max(mapper.keyframes)]
    v = kf.views[-1]
    with torch.no_grad():
        out = mapper.render_from_pose(kf.R, kf.t, v.width, v.height)
        m = kf.mask[-1]
        bad = m == 0
        loss = []
        for color, depth in ((out.color, out.depth),
                             (out.color.masked_fill(bad[..., None], 123.0),
                              out.depth.masked_fill(bad, 123.0))):
            loss.append(float(L.mapping_loss(
                color, kf.gt_color[-1], None, None, depth, kf.gt_depth[-1],
                m, opt.lambda_dssim)))
    n_bad = int(bad.sum())
    psnr = keyframe_psnr(mapper, masked=True)
    psnr_init = keyframe_psnr(mapper, init, masked=True)
    per_kf = [sum(remap_ms[i:i + 2]) for i in range(0, len(remap_ms), 2)]
    print(f"[undistort] {TUM_CAMERA} ({intr['width']}x{intr['height']}, fx "
          f"{intr['fx']}, dist_coeffs {intr['dist_coeffs']}) with "
          f"{TUM_MAPPER} (cut: min_num_initial_map_kfs "
          f"{UNDISTORT_MP['min_num_initial_map_kfs']}); {len(raw)} frames of"
          f" {UNDISTORT_ROOM['n_gaussians']} gaussians rendered pinhole and "
          f"distorted on the host (inverse residual {resid:.2g} px) in "
          f"{render_s:.1f} s; {len(mapper.keyframes)} keyframes; invalid "
          f"share {invalid:.4f}; card keyframes vs CPU: full level bit for "
          f"bit {exact}, sub-levels (steps, share) "
          f"{({k: (round(a, 3), round(b, 5)) for k, (a, b) in worst.items()})}"
          f"; mean abs to the pinhole render inside the mask: undistorted "
          f"{mae_und:.5f}, raw {mae_raw:.5f} ({mae_raw / mae_und:.1f}x); "
          f"loss with {n_bad} invalid pixels garbage {loss[1]:.8f} against "
          f"{loss[0]:.8f}; {mapper.iteration} iterations, ms per iteration "
          f"median {statistics.median(iter_ms):.2f} p90 "
          f"{pct(iter_ms, 0.9):.2f}; host ms in undistort_image per keyframe"
          f" (color + depth) median {statistics.median(per_kf):.2f} (max "
          f"{max(per_kf):.2f}, {len(per_kf)} keyframes); keyframe PSNR "
          f"inside the mask {psnr:.2f} dB (initial map {psnr_init:.2f}); "
          f"launches {launches}; run {run_s:.1f} s [{card}]")
    print(f"[clocks] undistort mapper: {clk.summary()} [{card}]")
    if not exact:
        fails.append("undistort: a card keyframe's full level differs from "
                     "the CPU's")
    for name, (steps, share) in worst.items():
        if not (steps <= 1.001 and share < 5e-3):
            fails.append(f"undistort: sub-level {name} {steps:.3g} steps "
                         f"apart on {share:.3g} of the values")
    if not mae_raw >= UNDISTORT_GAIN * mae_und:
        fails.append(f"undistort: the keyframe is {mae_raw / mae_und:.2f}x "
                     f"closer to the pinhole render, under {UNDISTORT_GAIN}")
    if not INVALID_SHARE[0] <= invalid <= INVALID_SHARE[1]:
        fails.append(f"undistort: invalid share {invalid:.4f} outside "
                     f"{INVALID_SHARE}")
    if not (n_bad > 0 and math.isclose(loss[1], loss[0], rel_tol=1e-6)):
        fails.append(f"undistort: garbage in {n_bad} invalid pixels moved "
                     f"the loss {loss[0]} -> {loss[1]}")
    if not all(math.isfinite(x) for x in losses):
        fails.append("undistort: loss not finite")
    if not psnr >= psnr_init + 3.0:
        fails.append(f"undistort: PSNR {psnr:.2f} not 3 dB above the "
                     f"initial map's {psnr_init:.2f}")
    for k, n in launches.items():
        if n == 0:
            fails.append(f"undistort: {k} launched no time")
    return launches


# [inertial]: frames stamped at EuRoC's 20 Hz camera rate with its 200 Hz
# IMU stream, synthesised from the GT poses (slam/imu.imu_from_poses)
CAMERA_HZ = 20.0
IMU_HZ = 200.0
# the gates of tests/test_tracking_imu.py:138-181: the mono-inertial
# Umeyama scale and unaligned ATE; the blackout (frames 16-19 black) and
# the dead-reckoned error bound
IMU_SCALE = (0.8, 1.25)
IMU_ATE_RAW = 0.45
BLACKOUT = (16, 20)
BLACKOUT_ERR = 0.3
# (c): the shipped EuRoC stereo pair, a synthetic EuRoC layout of
# [stereo]'s room at 752x480; the cuts of the mapper config, each for the
# time limit (a 12-frame sequence gives a map from its 3rd keyframe on,
# and the tail is 0.8 x the densification interval)
EUROC_CAMERA = "camera/Stereo/euroc.yaml"
EUROC_MAPPER = "gaussian_mapper/Stereo/euroc_stereo.yaml"
EUROC_ROOM = dict(n_frames=12, width=752, height=480, n_gaussians=7000,
                  seed=11, clutter_ratio=0.0, revolutions=0.15)
EUROC_CUTS = {"Mapper.min_num_initial_map_kfs": 3,
              "Optimization.densification_interval": 25}
EUROC_ITERS_PER_FRAME = 3
EUROC_T0_NS = 1403636579763555584


def imu_stream(frames):
    """The frames restamped at CAMERA_HZ, and the [K, 7] IMU rows between
    each frame and the one before it (None for the first)."""
    import dataclasses
    from legslam_torch.slam.imu import imu_from_poses
    times = np.arange(len(frames)) / CAMERA_HZ
    blocks = imu_from_poses(times, np.stack([f.c2w for f in frames]),
                            rate=IMU_HZ)
    return ([dataclasses.replace(f, timestamp=float(t))
             for f, t in zip(frames, times)], [None] + blocks)


def mono_inertial_run(dev, card, fails, out_dir, frames, intr):
    """[inertial] (a): [mono]'s room with its IMU stream through the
    mono-inertial tracker (depth and pose hidden) and a monocular mapper
    on the card."""
    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.eval_harness.metrics import ate_rmse
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam import tracking as T
    frames, imu = imu_stream(frames)
    kernels = path_kernels()
    for fn in kernels.values():
        fn.launches = 0
    fe = T.TrackingFrontend(intr, sensor="mono-inertial", imu_init_kfs=6,
                            kf_trans_th=0.05, kf_rot_deg_th=5.0, device=dev)
    mapper = GaussianMapper(
        fe.queue, intr, mp=MapperParams(min_num_initial_map_kfs=2),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16"),
        capacity=1 << 18, result_dir=out_dir, sensor_type="monocular",
        device=dev)
    ops = OpCounter(mapper)
    emitted, push = [], fe.queue.push

    def counted_push(op):
        emitted.append(op.kind.name)
        return push(op)
    fe.queue.push = counted_push
    track_ms = []
    for f, rows in zip(frames, imu):
        ta = time.perf_counter()
        fe.track(hide_gt(f, depth=None), imu=rows)
        track_ms.append((time.perf_counter() - ta) * 1e3)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(3):
                mapper.train_iteration()
    sync(dev)
    launches = {k: fn.launches for k, fn in kernels.items()}
    fids, traj = fe.trajectory()
    gt = np.stack([frames[int(i)].c2w for i in fids])[:, :3, 3]
    sim3 = ate_rmse(traj[:, :3, 3], gt)
    raw = ate_rmse(traj[:, :3, 3], gt, with_scale=False)["rmse"]
    n_sr = emitted.count("SCALE_REFINEMENT")
    applied = ops.kinds.get("SCALE_REFINEMENT", 0)
    print(f"[inertial] (a) mono-inertial: {len(frames)} frames "
          f"{intr['width']}x{intr['height']} at {CAMERA_HZ:g} Hz with "
          f"{IMU_HZ:g} Hz IMU rows, depth and pose hidden: imu_ready "
          f"{fe.imu_ready}, IMU inits {fe.n_imu_inits}, {fe.num_keyframes} "
          f"keyframes, lost {fe.lost_frames}, SCALE_REFINEMENT emitted "
          f"{n_sr} applied {applied}; Umeyama scale {sim3['scale']:.4f} "
          f"(gate {IMU_SCALE}), ATE Sim(3) {sim3['rmse']:.4f} m, unaligned "
          f"{raw:.4f} m (gate < {IMU_ATE_RAW}); tracker host ms a frame "
          f"median {statistics.median(track_ms):.2f} p90 "
          f"{pct(track_ms, 0.9):.2f}; monocular mapper {mapper.iteration} "
          f"iterations, launches {launches} [{card}]")
    if not (fe.imu_ready and fe.n_imu_inits >= 1):
        fails.append(f"inertial (a): IMU not initialized (ready "
                     f"{fe.imu_ready}, inits {fe.n_imu_inits})")
    if n_sr < 1 or applied < 1:
        fails.append(f"inertial (a): SCALE_REFINEMENT emitted {n_sr}, "
                     f"applied {applied}")
    if not IMU_SCALE[0] < sim3["scale"] < IMU_SCALE[1]:
        fails.append(f"inertial (a): Umeyama scale {sim3['scale']:.4f} "
                     f"outside {IMU_SCALE}")
    if not raw < IMU_ATE_RAW:
        fails.append(f"inertial (a): unaligned ATE {raw:.4f} >= "
                     f"{IMU_ATE_RAW}")
    return launches


def blackout_run(dev, card, fails, out_dir, frames, intr):
    """[inertial] (b): the same room through the rgbd-inertial tracker,
    frames BLACKOUT black (depth kept, as in
    tests/test_tracking_imu.py:155-181), and an RGB-D mapper on the card
    that trains on through the blackout. The tracker's world is its first
    camera's frame, the GT's the room's: the errors are taken after the
    SE(3) Umeyama alignment of the tracked frames before the blackout to
    the GT (JAX's test compares the two frames unaligned; those numbers
    are printed beside)."""
    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.eval_harness.metrics import umeyama_alignment
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam import tracking as T
    frames, imu = imu_stream(frames[:BLACKOUT[1]])
    kernels = path_kernels()
    for fn in kernels.values():
        fn.launches = 0
    fe = T.TrackingFrontend(intr, sensor="rgbd-inertial", imu_init_kfs=6,
                            reloc_after=10 ** 9, kf_trans_th=0.05,
                            kf_rot_deg_th=5.0, device=dev)
    mapper = GaussianMapper(
        fe.queue, intr, mp=MapperParams(min_num_initial_map_kfs=2),
        cfg=RasterizeConfig(backend="cuda", mm_dtype="bfloat16"),
        capacity=1 << 18, result_dir=out_dir, device=dev)
    track_ms, dark_losses, dark_iters = [], [], 0
    for k, (f, rows) in enumerate(zip(frames, imu)):
        dark = k >= BLACKOUT[0]
        if dark:
            f = hide_gt(f, color=np.zeros_like(f.color))
        ta = time.perf_counter()
        fe.track(hide_gt(f), imu=rows)
        track_ms.append((time.perf_counter() - ta) * 1e3)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(3):
                loss = mapper.train_iteration()
                if dark:
                    dark_iters += 1
                    if loss is not None:
                        dark_losses.append(loss)
    sync(dev)
    launches = {k: fn.launches for k, fn in kernels.items()}
    lead = range(BLACKOUT[0])
    gt = np.stack([f.c2w[:3, 3] for f in frames])
    R, t, _ = umeyama_alignment(
        np.stack([fe.poses[i][:3, 3] for i in lead]), gt[:BLACKOUT[0]],
        with_scale=False)
    last, frozen = fe.poses[BLACKOUT[1] - 1], fe.poses[BLACKOUT[0] - 1]
    err = float(np.linalg.norm(R @ last[:3, 3] + t - gt[-1]))
    err_frozen = float(np.linalg.norm(R @ frozen[:3, 3] + t - gt[-1]))
    raw = [float(np.linalg.norm(p[:3, 3] - gt[-1])) for p in (last, frozen)]
    print(f"[inertial] (b) rgbd-inertial through a blackout of frames "
          f"{BLACKOUT[0]}-{BLACKOUT[1] - 1}: imu_ready {fe.imu_ready}, lost "
          f"{fe.lost_frames}; frame {BLACKOUT[1] - 1}'s position error "
          f"after aligning frames 0-{BLACKOUT[0] - 1}: dead-reckoned "
          f"{err:.4f} m, frozen at frame {BLACKOUT[0] - 1} {err_frozen:.4f} "
          f"m (gate < {BLACKOUT_ERR} and < frozen; unaligned, as JAX's "
          f"test: {raw[0]:.4f} / {raw[1]:.4f}); tracker host ms a frame "
          f"median {statistics.median(track_ms):.2f} p90 "
          f"{pct(track_ms, 0.9):.2f}; RGB-D mapper {mapper.iteration} "
          f"iterations, {dark_iters} in the blackout (losses "
          f"{[round(x, 4) for x in dark_losses]}), launches {launches} "
          f"[{card}]")
    if fe.lost_frames < 3:
        fails.append(f"inertial (b): lost {fe.lost_frames} frames < 3")
    if not (err < BLACKOUT_ERR and err < err_frozen):
        fails.append(f"inertial (b): dead-reckoned error {err:.4f} m, frozen"
                     f" {err_frozen:.4f} m, bound {BLACKOUT_ERR}")
    n_dark = 3 * (BLACKOUT[1] - BLACKOUT[0])
    if dark_iters != n_dark or not all(math.isfinite(x)
                                       for x in dark_losses):
        fails.append(f"inertial (b): {dark_iters} iterations of {n_dark} in "
                     f"the blackout, losses {dark_losses}")
    return launches


def write_png(path, rgb):
    """An 8-bit RGB PNG of a float [H, W, 3] image in [0, 1] (stdlib zlib,
    no image library needed to write it)."""
    import struct
    import zlib
    img = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


def write_euroc(root, frames, rights, imu, intr, baseline) -> str:
    """A EuRoC MAV ASL layout (mav0/{cam0,cam1,imu0,
    state_groundtruth_estimate0}) of rectified pairs, modelled on
    tests/util.py make_euroc_dir: cam0 is the body frame, cam1 sits
    `baseline` along x, zero distortion; the IMU rows (imu_stream's, t in
    s from the first frame) in ns from the first frame's stamp."""
    from legslam_torch.utils.trajectory_io import _rot_to_quat
    mav = Path(root) / "seq" / "mav0"
    dt_ns = int(round(1e9 / CAMERA_HZ))
    for ci, cam in enumerate(("cam0", "cam1")):
        (mav / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i, img in enumerate(frames if ci == 0 else rights):
            ts = EUROC_T0_NS + i * dt_ns
            write_png(mav / cam / "data" / f"{ts}.png",
                      img.color if ci == 0 else img)
            lines.append(f"{ts},{ts}.png")
        (mav / cam / "data.csv").write_text("\n".join(lines) + "\n")
        off = baseline if ci else 0.0
        (mav / cam / "sensor.yaml").write_text(
            "sensor_type: camera\nT_BS:\n  rows: 4\n  cols: 4\n"
            f"  data: [1,0,0,{off}, 0,1,0,0, 0,0,1,0, 0,0,0,1]\n"
            f"resolution: [{intr['width']}, {intr['height']}]\n"
            f"intrinsics: [{intr['fx']}, {intr['fy']}, {intr['cx']}, "
            f"{intr['cy']}]\ndistortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")
    gt = mav / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    lines = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i, f in enumerate(frames):
        q = _rot_to_quat(f.c2w[:3, :3].astype(np.float64))
        p = f.c2w[:3, 3]
        lines.append(f"{EUROC_T0_NS + i * dt_ns},{p[0]},{p[1]},{p[2]},"
                     f"{q[0]},{q[1]},{q[2]},{q[3]}")
    (gt / "data.csv").write_text("\n".join(lines) + "\n")
    (mav / "imu0").mkdir(parents=True)
    rows = np.concatenate([imu[1]] + [b[1:] for b in imu[2:]])
    lines = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"] + [
        f"{EUROC_T0_NS + int(round(r[0] * 1e9))}," + ",".join(
            repr(float(x)) for x in r[1:]) for r in rows]
    (mav / "imu0" / "data.csv").write_text("\n".join(lines) + "\n")
    return str(mav.parent)


def euroc_app_run(dev, card, fails, out_dir):
    """[inertial] (c): apps/replica_rgbd.main with --frontend visual
    --sensor auto on a synthetic EuRoC layout with imu0 (write_euroc) at
    the pinhole K and baseline of the shipped EuRoC camera: the app sniffs
    stereo-inertial, the tracker's SGM runs on the card, the mapper takes
    the shipped EuRoC stereo config with EUROC_CUTS."""
    from legslam_torch.apps import replica_rgbd
    from legslam_torch.config import intrinsics_from_yaml, load_opencv_yaml
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.ops import stereo as S
    from legslam_torch.slam import tracking as T
    from legslam_torch.utils import ply
    out = Path(out_dir)
    cam = intrinsics_from_yaml(load_opencv_yaml(str(CFG_DIR / EUROC_CAMERA)))
    pin = {k: cam[k] for k in ("width", "height", "fx", "fy", "cx", "cy")}
    baseline = cam["stereo_baseline"]
    t0 = time.perf_counter()
    ds = SyntheticDataset(**EUROC_ROOM, device=dev)
    ds.intrinsics = dict(pin)
    frames, imu = imu_stream([ds.read(i) for i in range(len(ds))])
    rights = [right_view(f.color, f.depth, pin["fx"], baseline)
              for f in frames]
    scene = write_euroc(out / "data", frames, rights, imu, pin, baseline)
    cam_yaml = out / "euroc_pinhole.yaml"
    cam_yaml.write_text(
        "%YAML:1.0\n" + "".join(
            f"Camera1.{k}: {pin[k]}\n" for k in ("fx", "fy", "cx", "cy"))
        + f"Camera.width: {pin['width']}\nCamera.height: {pin['height']}\n"
        "Stereo.T_c1_c2: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
        f"  data: [1,0,0,{baseline}, 0,1,0,0, 0,0,1,0, 0,0,0,1]\n")
    mapper_yaml = out / "euroc_stereo_cut.yaml"
    mapper_yaml.write_text(
        (CFG_DIR / EUROC_MAPPER).read_text() + "\n# cuts for the time limit\n"
        + "".join(f"{k}: {v}\n" for k, v in EUROC_CUTS.items()))
    write_s = time.perf_counter() - t0

    fronts, calls, track_ms, sgm_devices = [], [], [], []
    frontend_cls, sgm = T.TrackingFrontend, S.sgm_disparity

    class Recording(frontend_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fronts.append(self)

        def track(self, frame, **kw):
            calls.append(kw)
            ta = time.perf_counter()
            try:
                return super().track(frame, **kw)
            finally:
                track_ms.append((time.perf_counter() - ta) * 1e3)

    def recorded_sgm(left, right, *a, **kw):
        sgm_devices.append(left.device.type)
        return sgm(left, right, *a, **kw)

    kernels = path_kernels()
    for fn in kernels.values():
        fn.launches = 0
    T.TrackingFrontend, S.sgm_disparity = Recording, recorded_sgm
    t0 = time.perf_counter()
    try:
        replica_rgbd.main([
            "--data", scene, "--out", str(out / "run"), "--cfg",
            str(mapper_yaml), "--camera-cfg", str(cam_yaml), "--frontend",
            "visual", "--sensor", "auto", "--no-lf", "--iters-per-frame",
            str(EUROC_ITERS_PER_FRAME), "--device", dev.type])
    finally:
        T.TrackingFrontend, S.sgm_disparity = frontend_cls, sgm
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    (fe,) = fronts
    imu_rows = [None if c.get("imu") is None else c["imu"].shape
                for c in calls]
    n_points = 0
    ply_path = out / "run" / "experiment" / "ply" / "point_cloud" / \
        "point_cloud.ply"
    if ply_path.exists():
        n_points = ply.load_gaussian_ply(str(ply_path))["xyz"].shape[0]
    tum = out / "run" / "CameraTrajectory_TUM.txt"
    ate = traj_ate(fe, frames)
    print(f"[inertial] (c) replica_rgbd.main --frontend visual --sensor "
          f"auto on a EuRoC layout (written in {write_s:.1f} s: "
          f"{len(frames)} rectified pairs {pin['width']}x{pin['height']} at "
          f"{CAMERA_HZ:g} Hz, fx {pin['fx']}, baseline {baseline:.6f} m from"
          f" {EUROC_CAMERA}, {IMU_HZ:g} Hz imu0) with {EUROC_MAPPER} cut to "
          f"{EUROC_CUTS}, {EUROC_ITERS_PER_FRAME} iterations a frame: sensor "
          f"{fe.sensor} use_imu {fe.use_imu}, IMU rows a frame "
          f"{[r[0] if r else None for r in imu_rows]}, SGM calls by device "
          f"{({d: sgm_devices.count(d) for d in set(sgm_devices)})}, "
          f"keyframes {fe.n_keyframes_created}, lost {fe.lost_frames}, ATE "
          f"Sim(3) {ate[0]:.4f} m unaligned {ate[1]:.4f} m; tracker host ms "
          f"a frame median {statistics.median(track_ms):.2f} p90 "
          f"{pct(track_ms, 0.9):.2f}; PLY {n_points} points, TUM "
          f"trajectory {tum.exists()}; launches {launches}; app "
          f"{run_s:.1f} s [{card}]")
    if not (fe.sensor == "stereo" and fe.use_imu):
        fails.append(f"inertial (c): the app's frontend is {fe.sensor}, "
                     f"use_imu {fe.use_imu}")
    if len(calls) != len(frames) or not all(
            r is not None and r[1] == 7 for r in imu_rows[1:]):
        fails.append(f"inertial (c): IMU rows a frame {imu_rows}")
    if not sgm_devices or any(d != dev.type for d in sgm_devices):
        fails.append(f"inertial (c): SGM ran on {sgm_devices}")
    if not n_points > 100:
        fails.append(f"inertial (c): the PLY holds {n_points} points")
    if not tum.exists():
        fails.append("inertial (c): no CameraTrajectory_TUM.txt")
    return launches


def inertial_phase(dev, card, fails, out_dir):
    """Phase 11 [inertial]: the three inertial sensor modes on the card, the
    tracker on its native route: (a) mono_inertial_run and (b)
    blackout_run on [mono]'s 640x480 room, (c) euroc_app_run through the
    app. Gates: each run's own, and every kernel launched in each. Returns
    the launches summed over the three runs."""
    from legslam_torch.data.synthetic import SyntheticDataset
    t0 = time.perf_counter()
    ds = SyntheticDataset(**MONO_ROOM, device=dev)
    frames = [ds.read(i) for i in range(len(ds))]
    secs = {"render": time.perf_counter() - t0}
    total = {}
    for name, run in (
            ("a", lambda o: mono_inertial_run(dev, card, fails, o, frames,
                                              ds.intrinsics)),
            ("b", lambda o: blackout_run(dev, card, fails, o, frames,
                                         ds.intrinsics)),
            ("c", lambda o: euroc_app_run(dev, card, fails, o))):
        t0 = time.perf_counter()
        launches = run(f"{out_dir}_{name}")
        secs[name] = time.perf_counter() - t0
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
            if n == 0:
                fails.append(f"inertial ({name}): {k} launched no time")
    print(f"[inertial] seconds {({k: round(v, 1) for k, v in secs.items()})}"
          f", launches over (a)-(c) {total} [{card}]")
    return total


# --- phase 12: the evaluation and offline entry points -----------------------

# phase 5's room rendered at the Replica camera the Replica reader assumes
# (fx = fy = 600 at 1200x680, data/datasets.py REPLICA_INTRINSICS: the
# layout carries no intrinsics), written as a Replica layout
EVAL_ROOM = dict(MAPPER_ROOM)
EVAL_SCENE = "room0"
# tests/test_scannet_miou.py's two-class scene at ScanNet's 640x480
# (bench.py's scannet unit), 20 frames, and that test's schedule
MIOU_ROOM = dict(n_frames=20, width=640, height=480, n_gaussians=1500,
                 seed=5, clutter_ratio=0.0)
MIOU_SCENE = "scene0000_00"
MIOU_OPT = dict(densify_from_iter=10, densification_interval=40,
                opacity_reset_interval=0, iterations=400, lang_feature_lr=0.1)
MIOU_MP = dict(min_num_initial_map_kfs=3, depth_cache=3)
MIOU_ITERS_PER_FRAME = 10
# two orthogonal unit class embeddings (tests/test_scannet_miou.py)
CLASS_EMBS = np.eye(2, 64, dtype=np.float32)
# the trainer's schedule, cut from 7,000 iterations (its default) for
# time: densify_until_iter = 700, so one densify runs at iteration 600
# (densify_from_iter 500, every 100), and the SH ramp reaches degree 1 at
# 1000; 1,300 is the least count that still densifies once
OFFLINE_ITERS = 1400
OFFLINE_EVAL_EVERY = 700
# the trainer's loss over its first and its last this many steps
LOSS_WINDOW = 100
RLS_MAX_FRAMES = 16
# gates of phase 12 (stated before its first run on the card)
EVAL_RTOL = 1e-3          # metrics of the kernels' renders vs the plain's
EVAL_GAIN = 3.0           # dB of [eval]'s map over its initial map
ATE_GT = 1e-6             # ate_rmse of the GT-pose frontend (rounding)
TIE_COS = 1e-4            # a pixel's class decision within this is a tie
# train_autoencoder card vs CPU, the parameters' max |err|: 40x the
# f32-vs-f64 gap of the same training on the CPU (2.6e-8; 1.5e-8 between
# CPU thread counts; tools/eval_cpu_figures.py ae)
AE_ATOL = 1e-6
AE_FRAMES = 4


def write_rgbd(color_path, depth_path, frame, depth_scale):
    """A frame's color as a quality-95 JPEG and its depth as a 16-bit PNG
    of depth_scale steps a metre (clipped to the PNG's range), with cv2."""
    import cv2
    rgb = (np.clip(frame.color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    depth = np.clip(np.rint(frame.depth * depth_scale), 0, 65535)
    if not (cv2.imwrite(str(color_path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, 95]) and
            cv2.imwrite(str(depth_path), depth.astype(np.uint16))):
        raise RuntimeError(f"cv2 could not write {color_path} / "
                           f"{depth_path}")


def write_replica(scene_dir, frames) -> str:
    """A Replica layout (examples/replica_rgbd.cpp:223-235) of `frames`:
    results/frame%06d.jpg, results/depth%06d.png at the reader's 6553.5 a
    metre (10 m at most) and traj.txt (one row-major camera-to-world a
    line)."""
    from legslam_torch.data.datasets import REPLICA_DEPTH_SCALE
    res = Path(scene_dir) / "results"
    res.mkdir(parents=True, exist_ok=True)
    for f in frames:
        write_rgbd(res / f"frame{f.index:06d}.jpg",
                   res / f"depth{f.index:06d}.png", f, REPLICA_DEPTH_SCALE)
    np.savetxt(str(Path(scene_dir) / "traj.txt"),
               np.stack([f.c2w.reshape(-1) for f in frames]))
    return str(scene_dir)


def write_scannet(scene_dir, frames, intr) -> str:
    """A ScanNet layout as tools/scannet_sens_reader.py exports it:
    color/N.jpg, depth/N.png (millimetres), pose/N.txt (camera-to-world)
    and intrinsic/intrinsic_color.txt (the 4x4 K of `intr`)."""
    from legslam_torch.data.datasets import SCANNET_DEPTH_SCALE
    root = Path(scene_dir)
    for sub in ("color", "depth", "pose", "intrinsic"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for f in frames:
        write_rgbd(root / "color" / f"{f.index}.jpg",
                   root / "depth" / f"{f.index}.png", f, SCANNET_DEPTH_SCALE)
        np.savetxt(str(root / "pose" / f"{f.index}.txt"), f.c2w)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (intr["fx"], intr["fy"], intr["cx"],
                                          intr["cy"])
    np.savetxt(str(root / "intrinsic" / "intrinsic_color.txt"), K)
    return str(scene_dir)


def eval_room(dev):
    """Phase 5's room (its 200k gaussians and orbit) rendered on the card at
    the Replica reader's camera: (frames, that camera, seconds)."""
    from legslam_torch.data.datasets import REPLICA_INTRINSICS
    from legslam_torch.data.synthetic import SyntheticDataset
    t0 = time.perf_counter()
    ds = SyntheticDataset(**EVAL_ROOM, device=dev)
    # the reader's K for the frame size (ReplicaDataset: REPLICA_INTRINSICS
    # itself at 1200x680)
    w, h = EVAL_ROOM["width"], EVAL_ROOM["height"]
    r = REPLICA_INTRINSICS
    sx, sy = w / r["width"], h / r["height"]
    ds.intrinsics = dict(width=w, height=h, fx=r["fx"] * sx, fy=r["fy"] * sy,
                         cx=(r["cx"] + 0.5) * sx - 0.5,
                         cy=(r["cy"] + 0.5) * sy - 0.5)
    frames = [ds.read(i) for i in range(len(ds))]
    sync(dev)
    return frames, ds.intrinsics, time.perf_counter() - t0


class Recorder:
    """Records each GaussianMapper a harness builds, with a copy of its
    store right after initialize_map: install() swaps the class the
    harness module names for a recording subclass until restore()."""

    def __init__(self, module):
        self.module, self.mappers, self.init = module, [], []
        self.cls = module.GaussianMapper

    def install(self):
        from legslam_torch.models import gaussians as G
        rec = self

        class Recording(self.cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.mappers.append(self)

            def initialize_map(self):
                super().initialize_map()
                rec.init.append(G.copy_state(self.state))
        self.module.GaussianMapper = Recording
        return self

    def restore(self):
        self.module.GaussianMapper = self.cls


def count_launches(dev, fn):
    """(fn(), {kernel: launches in the call}): the four counters are set to
    0 just before it and read after a synchronise."""
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    sync(dev)
    return out, {k: f.launches for k, f in kernels.items()}


@torch.no_grad()
def plain_render(mapper, kf):
    """The keyframe rendered with LF from the mapper's store through
    render_from_pose on the "torch" reference compositor with torch.sort,
    capped at 2^16 pairs a tile (the kernels cap none), on the mapper's
    device."""
    import dataclasses
    saved = mapper.cfg, mapper.max_per_tile
    mapper.cfg = dataclasses.replace(saved[0], backend="torch",
                                     cuda_sort=False)
    mapper.max_per_tile = 1 << 16
    try:
        return kf_render(mapper, kf)
    finally:
        mapper.cfg, mapper.max_per_tile = saved


@torch.no_grad()
def kf_render(mapper, kf, include_lang_feat=True, state=None):
    """The keyframe rendered as the harness renders it (render_from_pose
    at full resolution, the mapper's cfg), from `state` if given."""
    saved = mapper.state
    mapper.state = saved if state is None else state
    try:
        v = kf.views[-1]
        return mapper.render_from_pose(kf.R, kf.t, v.width, v.height,
                                       include_lang_feat=include_lang_feat)
    finally:
        mapper.state = saved


# a pair whose alpha sits at the 1/255 keep threshold within rounding is
# composited by one render and dropped by the other: what lies behind it
# moves by a factor 1 - 1/255
KEEP_FLIP = (1.0 + 1e-3) / 255.0


def render_acc(o) -> torch.Tensor:
    """[H, W, 3 + C + 1] color, LF and depth of a RasterizeOutput."""
    return torch.cat([o.color, o.lang_feat, o.depth[..., None]], -1)


def renders_agree(a, b) -> tuple[bool, int, float, list]:
    """Two renders of one store (the kernels' a, the plain compositor's b)
    at the forward tolerance (fwd_outside on color, LF and depth, and
    t_final), with check_kernels' exemption widened to the decisions both
    compositors take at rounding boundaries: at most 1e-4 of the pixels
    may be outside, each either ending with T <= 1e-2 in both (a
    termination test within rounding of its threshold) or with t_final
    apart by at most KEEP_FLIP of the larger (one pair at the alpha keep
    threshold). Returns (ok, pixels outside, max |err| elsewhere, up to 4
    outside pixels as (y, x, T_a, T_b, channel, a, b))."""
    acc_a, acc_b = render_acc(a), render_acc(b)
    bad = fwd_outside(acc_a, a.final_t, acc_b, b.final_t)
    n_bad = int(bad.sum())
    t_max = torch.maximum(a.final_t, b.final_t)
    flip = (t_max <= 1e-2) | \
        ((a.final_t - b.final_t).abs() <= KEEP_FLIP * t_max + 3e-5)
    ok = n_bad <= 1e-4 * bad.numel() and bool(flip[bad].all())
    good = ~bad
    diff = (acc_a - acc_b).abs()
    err = float(torch.maximum(diff.amax(-1), (a.final_t - b.final_t).abs())
                [good].max()) if bool(good.any()) else 0.0
    where = []
    for y, x in bad.nonzero()[:4].tolist():
        c = int(diff[y, x].argmax())
        where.append((y, x, float(a.final_t[y, x]), float(b.final_t[y, x]),
                      c, float(acc_a[y, x, c]), float(acc_b[y, x, c])))
    return ok, n_bad, err, where


def kf_metrics(out, kf, lp=None) -> dict:
    """The Replica harness's per-keyframe metrics of one render
    (eval_harness/replica_eval.run_scene)."""
    from legslam_torch.eval_harness import metrics as M
    from legslam_torch.ops import losses as L
    pred, gt = out.color.clamp(0, 1), kf.gt_color[-1]
    m = dict(psnr=float(L.psnr(pred, gt)), ssim=float(L.ssim(pred, gt)),
             depth_l1_cm=M.depth_l1_cm(out.depth.cpu().numpy(),
                                       kf.gt_depth[-1].cpu().numpy()))
    if lp is not None:
        from legslam_torch.models import lpips as LP
        m["lpips"] = float(LP.lpips(lp, pred, gt))
    return m


def eval_phase(dev, card, fails, out_dir, frames, intr, enc):
    """Phase 12 [eval]: the Replica harness as a user calls it.
    EVAL_ROOM's 40 frames written as a Replica layout (write_replica), then
    eval_harness/replica_eval.evaluate_scenes with NO cfg on "cuda": the
    harness resolves the "cuda" backend with float32 pair features; a
    keyframe every 4th frame, phase 6's seeded encoder on every frame, 7
    iterations a frame with phase 5's schedule (the map starts at 4
    keyframes, densify every 50 from 40), the tail, then each keyframe
    scored (PSNR, SSIM, depth-L1, LPIPS(alex) with seeded weights) and the
    experiment saved. Gates: the layout reads back with the camera `intr`
    the frames were rendered at; the harness's mapper on "cuda"; every kernel
    launched in the call; the log's psnr, ssim, lpips and depth_l1_cm
    finite and ate_rmse within ATE_GT of 0; each keyframe rendered from the
    trained store on the kernels and on the plain compositor in turn
    (renders_agree), and the metrics from the two within EVAL_RTOL; the
    mean keyframe PSNR EVAL_GAIN over the initial map's. Returns (launches,
    the layout's root, the experiment's PLY directory)."""
    from legslam_torch.config import MapperParams, OptimizationParams
    from legslam_torch.data.datasets import open_dataset
    from legslam_torch.eval_harness import replica_eval as RE
    from legslam_torch.models import lpips as LP
    t0 = time.perf_counter()
    root = Path(out_dir) / "replica"
    scene = write_replica(root / EVAL_SCENE, frames)
    read_intr = open_dataset(scene).intrinsics
    same_camera = read_intr.keys() == intr.keys() and all(
        math.isclose(read_intr[k], intr[k], rel_tol=1e-9) for k in intr)
    lpips_npz = Path(out_dir) / "lpips_alex.npz"
    np.savez(lpips_npz, **LP.init_params(np.random.default_rng(0)))
    write_s = time.perf_counter() - t0
    rec = Recorder(RE).install()
    try:
        with ClockSampler() as clk:
            results, launches = count_launches(dev, lambda: RE.evaluate_scenes(
                str(root), str(Path(out_dir) / "eval"), scenes=(EVAL_SCENE,),
                exp_name="chip", device=dev, kf_stride=4,
                iterations_per_frame=SYSTEM_ITERS_PER_FRAME, encoder=enc,
                lpips_weights=str(lpips_npz),
                opt=OptimizationParams(densify_from_iter=40,
                                       densification_interval=50),
                mp=MapperParams(min_num_initial_map_kfs=4)))
    finally:
        rec.restore()
    mapper, init = rec.mappers[0], rec.init[0]
    log = [json.loads(x) for x in (Path(out_dir) / "eval" /
                                   "eval_result_chip.log").read_text()
           .splitlines()]
    r = log[0]
    lp = LP.load_params(str(lpips_npz), dev)
    t0 = time.perf_counter()
    agree, n_out, err, gaps, outside = [], 0, 0.0, {}, []
    init_psnr = []
    for fid, kf in sorted(mapper.keyframes.items()):
        a = kf_render(mapper, kf)
        b = plain_render(mapper, kf)
        ok, n, e, where = renders_agree(a, b)
        agree.append(ok)
        n_out, err = n_out + n, max(err, e)
        outside += [(fid, *(float(f"{v:.6g}") for v in w)) for w in where]
        ma, mb = kf_metrics(a, kf, lp), kf_metrics(b, kf, lp)
        for k in ma:
            gaps[k] = max(gaps.get(k, 0.0),
                          abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-12))
        init_psnr.append(kf_metrics(kf_render(mapper, kf, False, init),
                                    kf)["psnr"])
    check_s = time.perf_counter() - t0
    p_init = statistics.mean(init_psnr)
    finite = all(math.isfinite(r.get(k, float("nan")))
                 for k in ("psnr", "ssim", "lpips", "depth_l1_cm"))
    print(f"[eval] replica_eval.evaluate_scenes on a Replica layout of "
          f"{len(frames)} frames {EVAL_ROOM['width']}x{EVAL_ROOM['height']} "
          f"(write {write_s:.1f} s), no cfg -> backend "
          f"{mapper.cfg.backend} {mapper.cfg.mm_dtype}, encoder on every "
          f"frame, {len(mapper.keyframes)} keyframes, {mapper.iteration} "
          f"iterations, num_valid {r['n_gaussians']}: fps {r['fps']} "
          f"total_time_s {r['total_time_s']}; psnr {r['psnr']:.4f} ssim "
          f"{r['ssim']:.4f} lpips {r.get('lpips', float('nan')):.4f} "
          f"depth_l1_cm {r['depth_l1_cm']:.4f} ate_rmse {r['ate_rmse']:.3g}"
          f"; initial map PSNR {p_init:.4f}; launches {launches}; kernels "
          f"vs plain compositor on every keyframe: {sum(agree)}/"
          f"{len(agree)} agree, {n_out} pixels outside (keyframe, y, x, "
          f"T kernels, T plain, worst channel, its values: {outside[:8]}),"
          f" max|err| elsewhere {err:.3g}; metric gaps (relative) "
          f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} } (gate "
          f"{EVAL_RTOL}); checks {check_s:.1f} s [{card}]")
    print(f"[clocks] eval harness: {clk.summary()} [{card}]")
    if not same_camera:
        fails.append(f"eval: the layout reads back with {read_intr}, not the "
                     f"camera it was rendered at {intr}")
    if mapper.cfg.backend != "cuda" or mapper.cfg.mm_dtype != "float32":
        fails.append(f"eval: the harness's default cfg is {mapper.cfg}")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"eval: {k} launched no time")
    if not finite or not abs(r["ate_rmse"]) <= ATE_GT:
        fails.append(f"eval: log line {r}")
    if not all(agree):
        fails.append(f"eval: kernels vs plain compositor differ on "
                     f"{len(agree) - sum(agree)} keyframes")
    if not all(v <= EVAL_RTOL for v in gaps.values()):
        fails.append(f"eval: metric gaps {gaps}")
    if not r["psnr"] >= p_init + EVAL_GAIN:
        fails.append(f"eval: PSNR {r['psnr']:.3f} not {EVAL_GAIN} dB over "
                     f"the initial map's {p_init:.3f}")
    return launches, str(root / EVAL_SCENE), results[0]["output"]


def run_legs_slam_phase(dev, card, fails, scene, out_dir):
    """Phase 12 [run_legs_slam]: POST /run_legs_slam on serving/api's stdlib
    server (127.0.0.1, an ephemeral port) on the [eval] layout with
    max_frames RLS_MAX_FRAMES: the handler runs run_scene at its defaults
    (no cfg) on the state's device. Gates: status "completed", finite
    metrics, the forward and backward kernels launched inside the request,
    the reply's kernel_launches equal to those counted around it. Returns
    the launches and the request with its reply's metrics and launches."""
    import threading

    from legslam_torch.serving import api
    server = api.serve_stdlib(api.ServiceState(device=str(dev)),
                              host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        (reply, ms), launches = count_launches(dev, lambda: _http(
            url + "/run_legs_slam", {"dataset_path": scene,
                                     "output_path": str(out_dir),
                                     "max_frames": RLS_MAX_FRAMES}))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    m = reply.get("metrics", {})
    finite = all(math.isfinite(m.get(k, float("nan")))
                 for k in ("psnr", "ssim", "depth_l1_cm"))
    shown = {k: m.get(k) for k in ("frames", "psnr", "ssim", "depth_l1_cm",
                                   "n_gaussians", "fps")}
    reported = reply.get("kernel_launches")
    served = {k: launches[k] for k in SERVER_KERNELS}
    print(f"[run_legs_slam] POST /run_legs_slam (max_frames "
          f"{RLS_MAX_FRAMES}) on serve_stdlib: status {reply.get('status')}"
          f" in {ms:.1f} ms (host clock); metrics {shown}; launches "
          f"{launches}, the reply's kernel_launches equal: "
          f"{reported == served} [{card}]")
    if reply.get("status") != "completed" or not finite:
        fails.append(f"run_legs_slam: {reply}")
    if reported != served:
        fails.append(f"run_legs_slam: the reply's kernel_launches "
                     f"{reported} vs counted {served}")
    for k in ("composite_fwd", "composite_bwd"):
        if launches[k] == 0:
            fails.append(f"run_legs_slam: {k} launched no time")
    return launches, dict(dataset_path=scene, max_frames=RLS_MAX_FRAMES,
                          metrics=m, launches=launches)


def miou_scene(dev, root):
    """MIOU_ROOM with each gaussian's LF the class embedding of its world
    x sign (tests/test_scannet_miou.py), rendered on the card and written as
    a ScanNet layout; returns (scene dir, {fid: [37, 37, 64] unit LF
    supervision}, {fid: [H, W] labels, 0 where the field covers under
    half})."""
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.ops.rasterize import rasterize
    from legslam_torch.utils.camera import CameraView
    from legslam_torch.utils.sh import rgb_to_sh
    ds = SyntheticDataset(**MIOU_ROOM, device=dev)
    ds._lf = CLASS_EMBS[(ds._xyz[:, 0] > 0.0).astype(int)]
    intr = ds.intrinsics
    frames = [ds.read(i) for i in range(len(ds))]
    n = ds._xyz.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    sh = torch.zeros(n, 16, 3, device=dev)
    sh[:, 0] = rgb_to_sh(t(ds._colors))
    lfs, labels = {}, {}
    for f in frames:
        w2c = np.linalg.inv(f.c2w)
        view = CameraView.create(w2c[:3, :3], w2c[:3, 3], intr["width"],
                                 intr["height"], fx=intr["fx"], fy=intr["fy"],
                                 device=dev)
        out = rasterize(t(ds._xyz), sh, t(ds._lf), t(ds._opacity),
                        t(ds._scales), t(ds._quats),
                        torch.ones(n, dtype=torch.bool, device=dev), view,
                        torch.zeros(3, device=dev), 0, ds._cfg,
                        include_lang_feat=True, max_per_tile=1024)
        lf = out.lang_feat
        hit = (1.0 - out.final_t > 0.5).cpu().numpy()
        cls = np.where((lf[..., 0] > lf[..., 1]).cpu().numpy(), 1, 2)
        labels[f.index] = np.where(hit, cls, 0).astype(np.int32)
        unit = lf / torch.linalg.vector_norm(lf, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
        lfs[f.index] = torch.nn.functional.interpolate(
            unit.permute(2, 0, 1)[None], size=(37, 37), mode="bilinear",
            align_corners=False)[0].permute(1, 2, 0).cpu().numpy()
    return write_scannet(root / MIOU_SCENE, frames, intr), lfs, labels


def decisions(lf):
    """segment_prediction's labels of a [H, W, 64] LF render over
    CLASS_EMBS at the reference's reject rule (score 0.7, i.e. cosine
    -0.4), and the pixels whose decision is a tie within TIE_COS: the two
    classes' cosines that close, or the better one that close to -0.4 (a
    pixel the map leaves at LF 0 is rejected, not tied)."""
    from legslam_torch.eval_harness import metrics as M
    lf = lf.cpu().numpy()
    norm = np.linalg.norm(lf, axis=-1, keepdims=True)
    cos = lf / norm.clip(1e-12) @ CLASS_EMBS.T
    tie = (norm[..., 0] > 0) & (
        (np.abs(cos[..., 0] - cos[..., 1]) <= TIE_COS) |
        (np.abs(cos.min(-1) + 0.4) <= TIE_COS))
    return M.segment_prediction(lf, CLASS_EMBS, 0.7), tie


def miou_phase(dev, card, fails, out_dir):
    """Phase 12 [miou]: the ScanNet harness. miou_scene's layout through
    eval_harness/scannet_eval.evaluate_scenes with NO cfg on "cuda" (the
    harness resolves the "cuda" backend), text_embs CLASS_EMBS, the labels
    through label_loader_factory and the LF supervision through lf_loader,
    a keyframe every 4th frame, MIOU_ITERS_PER_FRAME iterations a frame with
    tests/test_scannet_miou.py's schedule (MIOU_OPT, MIOU_MP), every
    keyframe scored at the reference's reject rule (0.7). Gates: every
    kernel launched; the confusion matrix from the kernels' LF renders
    equals the plain compositor's over every pixel but the ties of
    `decisions` in either render (their count printed); the trained map's
    mIoU above the initial map's; create_comparison_video writes a
    non-empty file. Returns the launches."""
    from legslam_torch.config import MapperParams, OptimizationParams
    from legslam_torch.eval_harness import metrics as M
    from legslam_torch.eval_harness import replica_eval as RE
    from legslam_torch.eval_harness import scannet_eval as SE
    root = Path(out_dir) / "scannet"
    t0 = time.perf_counter()
    scene, lfs, labels = miou_scene(dev, root)
    scene_s = time.perf_counter() - t0
    rec = Recorder(RE).install()
    try:
        results, launches = count_launches(dev, lambda: SE.evaluate_scenes(
            str(root), str(Path(out_dir) / "eval"), [MIOU_SCENE],
            text_embs=CLASS_EMBS,
            label_loader_factory=lambda s: (lambda fid: labels[fid]),
            exp_name="chip", every_nth=1, device=dev, kf_stride=4,
            iterations_per_frame=MIOU_ITERS_PER_FRAME,
            lf_loader=lambda f: lfs[f.index],
            opt=OptimizationParams(**MIOU_OPT), mp=MapperParams(**MIOU_MP)))
    finally:
        rec.restore()
    mapper, init = rec.mappers[0], rec.init[0]
    r = results[0]
    conf_k = np.zeros((3, 3), np.int64)
    conf_p = np.zeros((3, 3), np.int64)
    n_tie = n_diff = 0
    for fid, kf in sorted(mapper.keyframes.items()):
        pk, tk = decisions(kf_render(mapper, kf).lang_feat)
        pp, tp = decisions(plain_render(mapper, kf).lang_feat)
        keep = ~(tk | tp)
        n_tie += int((~keep).sum())
        n_diff += int((pk != pp).sum())
        gt = np.where(keep, labels[fid], 0)
        conf_k += M.confusion_matrix(pk, gt, 3)
        conf_p += M.confusion_matrix(pp, gt, 3)
    st = mapper.state
    mapper.state = init
    try:
        init_scores = SE.evaluate_segmentation(
            mapper, CLASS_EMBS, lambda fid: labels[fid],
            sorted(mapper.keyframes), 3, every_nth=1)
    finally:
        mapper.state = st
    video = SE.create_comparison_video(
        mapper, CLASS_EMBS, lambda fid: labels[fid],
        sorted(mapper.keyframes), str(Path(out_dir) / "video"))
    size = Path(video).stat().st_size if video else 0
    print(f"[miou] scannet_eval.evaluate_scenes on a ScanNet layout of "
          f"{MIOU_ROOM['n_frames']} frames {MIOU_ROOM['width']}x"
          f"{MIOU_ROOM['height']} (two classes by world x; scene "
          f"{scene_s:.1f} s), no cfg -> backend {mapper.cfg.backend}, "
          f"{len(mapper.keyframes)} keyframes, {mapper.iteration} "
          f"iterations: miou {r['miou']:.4f} macc {r['macc']:.4f} per-class "
          f"IoU {[round(x, 4) for x in r['per_class_iou']]} (initial map "
          f"miou {init_scores['miou']:.4f}), psnr {r['psnr']:.3f}; launches "
          f"{launches}; confusion kernels == plain compositor off the ties: "
          f"{bool(np.array_equal(conf_k, conf_p))} ({n_tie} tie pixels "
          f"within {TIE_COS}, {n_diff} pixels decided differently); "
          f"comparison video {size} bytes [{card}]")
    for k, v in launches.items():
        if v == 0:
            fails.append(f"miou: {k} launched no time")
    if not np.array_equal(conf_k, conf_p):
        fails.append(f"miou: confusion {conf_k.tolist()} on the kernels vs "
                     f"{conf_p.tolist()} on the plain compositor")
    if not r["miou"] > init_scores["miou"]:
        fails.append(f"miou: {r['miou']} not above the initial map's "
                     f"{init_scores['miou']}")
    if not size > 0:
        fails.append("miou: no comparison video")
    return launches


# a train_step on the card against the same step on the CPU. The kernels
# and their plain versions sum in other orders (the forward within atol
# 3e-5 / rtol 1e-3, check_kernels), so the loss is held at the forward's
# rtol, not step_ok's 1e-6 (which holds two runs of the same kernels); the
# Adam moments and the densify statistics at STEP_RTOL, as step_ok holds
# them; the parameters at STEP_ATOL wherever the first moment is above
# the gradient tolerance, 2e-4 of its group's largest (check_kernels,
# tests/test_pallas_grad.py): Adam's first step moves a parameter by
# lr * sign(g), and below that tolerance the sign is rounding noise
CROSS_LOSS_RTOL = 1e-3
GRAD_FLOOR = 2e-4


def cross_step(a, b, l_a, l_b) -> tuple[bool, dict]:
    """(ok, errors) of store a (a step on the card, moved to the CPU)
    against b (the same step on the CPU) and their losses: step_errs'
    errors with 'params' over the elements whose gradient is above
    GRAD_FLOOR, 'noise_flips' the elements below it that moved apart by
    more than STEP_ATOL, and 'loss' relative."""
    from legslam_torch.models import gaussians as G
    errs = step_errs(a, b)
    errs["params_all"], errs["params"], errs["noise_flips"] = \
        errs["params"], 0.0, 0
    for n in G.GROUPS:
        m = getattr(b.adam_m, n).abs()
        above = m > GRAD_FLOOR * float(m.max())
        d = (getattr(a.params, n) - getattr(b.params, n)).abs()
        if bool(above.any()):
            errs["params"] = max(errs["params"], float(d[above].max()))
        errs["noise_flips"] += int(((d > STEP_ATOL) & ~above).sum())
    errs["loss"] = abs(l_a - l_b) / abs(l_b)
    ok = errs["loss"] <= CROSS_LOSS_RTOL and \
        errs["params"] <= STEP_ATOL and errs["adam_m"] <= STEP_RTOL and \
        errs["grad_accum"] <= STEP_RTOL
    return ok, errs


class StepSpy:
    """Wraps train_step for apps/train_offline.main: keeps copies of the
    first call's arguments and result, and each call's host ms (with a
    synchronise) and loss."""

    def __init__(self, step, dev):
        self.step, self.dev, self.first = step, dev, None
        self.ms, self.losses = [], []

    def __call__(self, state, *a, **k):
        from legslam_torch.models import gaussians as G
        seed = G.copy_state(state) if self.first is None else None
        t0 = time.perf_counter()
        out = self.step(state, *a, **k)
        sync(self.dev)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.losses.append(float(out[1].loss))
        self.last = (out[1], a, k)
        if seed is not None:
            self.first = (seed, a, k, G.copy_state(out[0]),
                          self.losses[-1])
            self.first_parts = loss_parts(*self.last)
        return out


def loss_parts(aux, a, k) -> tuple[float, float]:
    """The color terms, (1 - l) L1 + l (1 - SSIM), and the depth L1 of a
    train_step's loss (ops/losses.mapping_loss), from its render (aux) and
    its targets (a: gt_color, gt_depth and mask at 5, 7 and 8)."""
    from legslam_torch.ops import losses as L
    lam, gt, gt_d, mask = k["opt"].lambda_dssim, a[5], a[7], a[8]
    pc = aux.color * mask[..., None]
    return (float((1 - lam) * L.l1_loss(pc, gt) +
                  lam * (1 - L.ssim(pc, gt))),
            float(L.l1_loss(aux.depth * mask, gt_d)))


def to_cpu(x):
    """A tensor, or a dataclass of them (GaussianState, its groups), on the
    CPU; anything else as it is."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_cpu(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


@torch.no_grad()
def seeded_test_psnr(scene, state, stride, hold, cfg, dev) -> float:
    """Mean test-PSNR of `state` over apps/train_offline's held-out
    keyframes (every `hold`-th of the frames at `stride`), as its
    evaluate() renders them."""
    from legslam_torch.data.datasets import open_dataset
    from legslam_torch.mapper.keyframe import build_keyframe
    from legslam_torch.ops import losses as L
    from legslam_torch.ops.rasterize import rasterize
    from legslam_torch.slam.interface import KeyframePacket
    ds = open_dataset(scene)
    out = []
    for k, i in enumerate(range(0, len(ds), stride)):
        if k % hold:
            continue
        f = ds.read(i)
        w2c = np.linalg.inv(f.c2w).astype(np.float32)
        kf = build_keyframe(KeyframePacket(
            fid=i, timestamp=f.timestamp, R=w2c[:3, :3], t=w2c[:3, 3],
            color=f.color, depth=f.depth, lf_image=None), ds.intrinsics, 0,
            (), 0, 0, device=dev)
        r = rasterize(state.params.xyz, state.sh(), state.params.lang_feat,
                      state.opacities(), state.scales(), state.params.rotation,
                      state.valid, kf.views[-1], torch.zeros(3, device=dev), 0,
                      cfg, include_lang_feat=False)
        out.append(float(L.psnr(r.color.clamp(0, 1), kf.gt_color[-1])))
    return statistics.mean(out)


def offline_phase(dev, card, fails, scene, out_dir):
    """Phase 12 [offline]: apps/train_offline.main on the [eval] layout,
    --iterations OFFLINE_ITERS --frame-stride 4 --eval-every
    OFFLINE_EVAL_EVERY on "cuda", its seed cloud from the numpy keypoint
    grid (trajectory._HAS_CV2 off for the run: cv2's corners in this fog
    are ~100 a frame). Gates: the first train_step from the seeded store,
    card against CPU on the same inputs, within cross_step; the gaussian
    count changes at the densify; the median loss of the last LOSS_WINDOW
    steps below that of the first (the test-PSNR is printed beside the
    seeded store's, not gated: from this dense seed the reference's
    schedule lowers the held-out views' PSNR, PERF.md §6); the
    forward and backward kernels each launched
    at least OFFLINE_ITERS times; checkpoint.npz loaded with
    load_checkpoint(device="cpu") equals the card's final store bit for
    bit. Returns the launches."""
    import contextlib
    import io
    import re

    from legslam_torch.apps import train_offline
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.mapper import checkpoint as CK
    from legslam_torch.mapper import train_step as TS
    from legslam_torch.models import gaussians as G
    from legslam_torch.slam import trajectory
    spy = StepSpy(TS.train_step, dev)
    densify, save = G.densify_and_prune, CK.save_checkpoint
    densified, saved = [], []

    def counted_densify(state, *a, **k):
        n0 = int(state.num_valid())
        out = densify(state, *a, **k)
        densified.append((n0, int(out.num_valid())))
        return out

    def kept_save(path, state, meta=None):
        saved.append((path, G.copy_state(state)))
        return save(path, state, meta)
    text = io.StringIO()
    TS.train_step, G.densify_and_prune = spy, counted_densify
    CK.save_checkpoint = kept_save
    has_cv2, trajectory._HAS_CV2 = trajectory._HAS_CV2, False
    try:
        with ClockSampler() as clk, contextlib.redirect_stdout(text):
            _, launches = count_launches(dev, lambda: train_offline.main([
                "--data", scene, "--out", str(out_dir), "--iterations",
                str(OFFLINE_ITERS), "--frame-stride", "4", "--eval-every",
                str(OFFLINE_EVAL_EVERY), "--device", dev.type]))
    finally:
        TS.train_step, G.densify_and_prune = spy.step, densify
        CK.save_checkpoint = save
        trajectory._HAS_CV2 = has_cv2
    log = text.getvalue()
    psnrs = [float(x) for x in re.findall(r"test-PSNR=([-0-9.]+)", log)]
    seed, a, k, card_st, card_loss = spy.first
    t0 = time.perf_counter()
    cpu_st, cpu_aux = spy.step(to_cpu(seed), *map(to_cpu, a),
                               **{n: to_cpu(v) for n, v in k.items()})
    cpu_s = time.perf_counter() - t0
    step_good, errs = cross_step(to_cpu(card_st), cpu_st, card_loss,
                                 float(cpu_aux.loss))
    psnr_seed = seeded_test_psnr(scene, seed, 4, 8,
                                 RasterizeConfig(backend="cuda"), dev)
    path, final = saved[-1]
    loaded, meta = CK.load_checkpoint(path, device="cpu")
    same = all(torch.equal(x.cpu(), y) for x, y in
               zip(G.state_tensors(final), G.state_tensors(loaded)))
    ms = spy.ms
    l_first = statistics.median(spy.losses[:LOSS_WINDOW])
    l_last = statistics.median(spy.losses[-LOSS_WINDOW:])
    parts = (spy.first_parts, loss_parts(*spy.last))
    print(f"[offline] apps/train_offline.main --iterations {OFFLINE_ITERS} "
          f"--frame-stride 4 --eval-every {OFFLINE_EVAL_EVERY} on the "
          f"[eval] layout: seeded store {int(seed.num_valid())} gaussians "
          f"(numpy keypoint grid), densify (before, after) {densified}, "
          f"final {int(final.num_valid())}; test-PSNR "
          f"{psnrs} (seeded store {psnr_seed:.4f}); median loss of the "
          f"first / last {LOSS_WINDOW} steps {l_first:.5f} / {l_last:.5f} "
          f"(color terms, depth L1 of the first and the last step "
          f"{[tuple(round(x, 5) for x in p) for p in parts]}); "
          f"ms a train_step "
          f"median {statistics.median(ms):.2f} p90 {pct(ms, 0.9):.2f} (host "
          f"clock, synchronised); launches {launches}; first step card vs "
          f"CPU ({cpu_s:.1f} s on the host): loss {card_loss:.8f} / "
          f"{float(cpu_aux.loss):.8f}, "
          f"{errs_text(errs)} (cross_step {step_good}); checkpoint {meta} "
          f"loads on the CPU equal bit for bit: {same} [{card}]")
    print(f"[clocks] offline trainer: {clk.summary()} [{card}]")
    if not step_good:
        fails.append(f"offline: first step card vs CPU {errs_text(errs)}")
    if not densified or densified[0][0] == densified[0][1]:
        fails.append(f"offline: the densify left the count as it was "
                     f"{densified}")
    if len(psnrs) != OFFLINE_ITERS // OFFLINE_EVAL_EVERY or \
            not all(math.isfinite(x) for x in psnrs):
        fails.append(f"offline: test-PSNR lines {psnrs}")
    if not l_last < l_first:
        fails.append(f"offline: median loss {l_first} -> {l_last} did not "
                     f"fall")
    for k in ("composite_fwd", "composite_bwd"):
        if launches[k] < OFFLINE_ITERS:
            fails.append(f"offline: {k} launched {launches[k]} times in "
                         f"{OFFLINE_ITERS} iterations")
    if not same:
        fails.append("offline: the checkpoint differs from the final store")
    return launches


def detect_phase(dev, card, fails, experiment, out_dir):
    """Phase 12 [detect]: apps/detect_objects.main on [eval]'s saved
    experiment (its PLY and the keyframes' cameras) with two seeded unit
    --text-embs prompts, on "cuda". Gates: detections.json written, the
    forward and both sort kernels launched; every camera rendered from the
    PLY's store on the kernels and on the plain compositor (the "torch"
    compositor with torch.sort on the card) in turn, the two agreeing
    (renders_agree); and the heats of all the views, as
    detect_objects_in_frames makes them from the kernels' renders, equal
    within PAMR_ERR those made from the plain compositor's LF with the
    kernels' RGB as PAMR's guide. The guide is shared because PAMR
    divides each pixel's color differences by their spread over its
    neighbours, which in a flat region is rounding noise: there two
    renders whose colors differ by rounding give other affinities, and
    the heats move by up to 1.35e-4 (tools/eval_cpu_figures.py pamr: a
    flat wall on the CPU, where a shared guide leaves 3e-7). The heats
    with each render's own guide are printed beside the gated ones. The pixels renders_agree lets through
    (a pair at the alpha keep threshold or a termination test, decided
    the other way) take the kernels' LF in the plain side too. Returns the
    launches."""
    import contextlib
    import io

    from legslam_torch.apps import detect_objects
    from legslam_torch.apps.find_objects import (load_map, make_renderer,
                                                 pamr_fn)
    from legslam_torch.config import RasterizeConfig
    from legslam_torch.eval_harness.detect_objects import (
        detect_objects_in_frames)
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(2, 64)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    npy = Path(out_dir) / "text_embs.npy"
    npy.parent.mkdir(parents=True, exist_ok=True)
    np.save(npy, embs)
    prompts = ["a chair", "a table"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, launches = count_launches(dev, lambda: detect_objects.main([
            "--scene", experiment, "--text-embs", str(npy), "--prompts",
            *prompts, "--out", str(out_dir)], device=dev))
    secs = time.perf_counter() - t0
    found = json.loads((Path(out_dir) / "detections.json").read_text())
    cams = json.loads((Path(experiment) / "cameras.json").read_text())
    st, _ = load_map(str(Path(experiment) / "point_cloud" /
                         "point_cloud.ply"), dev)
    kern = make_renderer(st, None, 2048)
    plain = make_renderer(st, RasterizeConfig(backend="torch",
                                              cuda_sort=False), 1 << 16)
    views = {"kernels": [], "plain": [], "shared": []}
    agree, n_out = [], []
    for cam in cams:
        R = np.asarray(cam["rotation"], np.float32).T
        t = -(R @ np.asarray(cam["position"], np.float32))
        shot = (R, t, cam["width"], cam["height"], cam["fx"], cam["fy"])
        a, b = kern(*shot), plain(*shot)
        ok, n, _, _ = renders_agree(a, b)
        agree.append(ok)
        n_out.append(n)
        bad = fwd_outside(render_acc(a), a.final_t, render_acc(b), b.final_t)
        rgb = a.color.clamp(0, 1)
        views["kernels"].append((rgb, a.lang_feat, a.depth))
        views["plain"].append((b.color.clamp(0, 1), b.lang_feat, b.depth))
        views["shared"].append((rgb, torch.where(bad[..., None], a.lang_feat,
                                                 b.lang_feat), b.depth))
    heats = {}
    for k, v in views.items():
        heats[k] = detect_objects_in_frames(
            lambda *_, shots=iter(v): next(shots), cams, embs, prompts,
            pamr_fn=pamr_fn).heats
    del views
    h_err = float(np.abs(heats["kernels"] - heats["shared"]).max())
    raw = np.abs(heats["kernels"] - heats["plain"]).max(axis=(0, 2, 3))
    print(f"[detect] apps/detect_objects.main on [eval]'s experiment "
          f"({len(found['frames'])} cameras, prompts {prompts}): counts "
          f"{found['counts']}, {secs:.1f} s; launches {launches}; every "
          f"view rendered on the kernels and on the plain compositor: "
          f"{sum(agree)}/{len(agree)} agree, pixels outside by view "
          f"{n_out}; heats of all views, kernels vs plain compositor's "
          f"LF (those pixels the kernels'), PAMR guided by the kernels' "
          f"RGB, max|err| {h_err:.3g} (gate {PAMR_ERR}); each by its own "
          f"RGB, max|err| by view "
          f"{[float(f'{x:.3g}') for x in raw]} [{card}]")
    for k in ("composite_fwd", "sort_keys", "sort_kv"):
        if launches[k] == 0:
            fails.append(f"detect: {k} launched no time")
    if not all(agree):
        fails.append(f"detect: kernels vs plain compositor differ on "
                     f"{len(agree) - sum(agree)} views")
    if not h_err <= PAMR_ERR:
        fails.append(f"detect: heats differ by {h_err}")
    return launches


@torch.no_grad()
def encoder_features(enc, frames) -> torch.Tensor:
    """[B, 1369, 768] unit DINOv2 tokens of `frames` on the encoder's
    device: models/encoder.encode up to the PCA."""
    from legslam_torch.models import dinov2 as D
    x = torch.as_tensor(np.stack([f.color for f in frames]),
                        device=enc.device)
    size = enc.cfg.image_size
    x = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
        align_corners=False, antialias=True).permute(0, 2, 3, 1)
    f = D.forward_cast(enc._cast_params, D.imagenet_normalize(x, *enc._norm),
                       enc.cfg, enc.dtype)
    return f / torch.linalg.vector_norm(f, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def ae_phase(dev, card, fails, frames, enc):
    """Phase 12 [ae]: models/autoencoder.train_autoencoder (768 -> 64 ->
    768, Adam, 5 epochs) on the card and on the CPU from the same init
    draws (a CPU generator, seed 0), on phase 6's encoder features of
    AE_FRAMES frames. Gates: the parameters agree within AE_ATOL; the
    reconstruction loss falls."""
    from legslam_torch.models import autoencoder as AE
    feats = encoder_features(enc, frames[:AE_FRAMES])
    batches = list(feats.cpu().numpy())
    d = feats.shape[-1]
    card_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        card_p = AE.train_autoencoder(
            batches, torch.Generator().manual_seed(0), d=d, device=dev)
        sync(dev)
        card_s.append(time.perf_counter() - t0)
    cpu_p = AE.train_autoencoder(batches, torch.Generator().manual_seed(0),
                                 d=d, device="cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_p, cpu_p))
    init = AE.init(torch.Generator().manual_seed(0), d=d, device=dev)

    def loss(p):
        return float(torch.mean((AE.decode(p, AE.encode(p, feats)) - feats)
                                ** 2))
    l0, l1 = loss(init), loss(card_p)
    print(f"[ae] train_autoencoder on {AE_FRAMES} frames' encoder features "
          f"{tuple(feats.shape)}, {5 * AE_FRAMES} Adam steps: card vs CPU "
          f"parameters max|err| {err:.3g} (gate {AE_ATOL}); loss {l0:.6g} -> "
          f"{l1:.6g}; on the card {card_s[0]:.2f} s the first call, "
          f"{card_s[1]:.2f} s the second (host clock) [{card}]")
    if not err <= AE_ATOL:
        fails.append(f"ae: card vs CPU parameters differ by {err}")
    if not l1 < l0:
        fails.append(f"ae: loss {l0} -> {l1} did not fall")


def evaluation_phase(dev, card, fails, out_dir, enc):
    """Phase 12: the evaluation and offline entry points on the card (see
    eval_phase, run_legs_slam_phase, miou_phase, offline_phase,
    detect_phase, ae_phase). Returns each kernel's launches summed over the
    parts that run the kernels, and [run_legs_slam]'s request with its
    reply's metrics (phase 13 sends it to the deployed server)."""
    out = Path(out_dir)
    secs = {}
    frames, intr, secs["render"] = eval_room(dev)
    parts = {}
    t0 = time.perf_counter()
    parts["eval"], scene, experiment = eval_phase(
        dev, card, fails, out / "eval", frames, intr, enc)
    secs["eval"] = time.perf_counter() - t0
    for name, run in (
            ("run_legs_slam", lambda: run_legs_slam_phase(
                dev, card, fails, scene, out / "run_legs_slam")),
            ("miou", lambda: miou_phase(dev, card, fails, out / "miou")),
            ("offline", lambda: offline_phase(dev, card, fails, scene,
                                              out / "offline")),
            ("detect", lambda: detect_phase(dev, card, fails, experiment,
                                            out / "detect"))):
        t0 = time.perf_counter()
        parts[name] = run()
        secs[name] = time.perf_counter() - t0
        if name == "run_legs_slam":
            parts[name], rls = parts[name]
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ae_phase(dev, card, fails, frames, enc)
    secs["ae"] = time.perf_counter() - t0
    total = {k: sum(p[k] for p in parts.values()) for k in parts["eval"]}
    print(f"[evaluation] seconds {({k: round(v, 1) for k, v in secs.items()})}"
          f"; launches by part {parts} [{card}]")
    return total, rls


# --- phase 13: the deployment path -------------------------------------------

REPO = Path(__file__).resolve().parent
DOCKERFILE = REPO / "Dockerfile.torch"
CUDA_KERNELS = ("composite_fwd", "composite_bwd", "sort", "prologue", "sgm")
PIP = ("-m", "pip", "--disable-pip-version-check", "--no-cache-dir",
       "--quiet")


def build_wheel(work: Path) -> Path:
    """A wheel of the tree as a user builds one (pip wheel --no-deps
    --no-build-isolation), from a copy of its packaging files and
    packages under `work`, so the checkout gets no build files; returns
    the wheel's path."""
    src = work / "src"
    src.mkdir(parents=True)
    for f in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / f, src / f)
    for d in ("legslam_tpu", "legslam_torch"):
        shutil.copytree(REPO / d, src / d, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so"))
    subprocess.run([sys.executable, *PIP, "wheel", ".", "--no-deps",
                    "--no-build-isolation", "--no-index", "-w",
                    str(work / "wheel")],
                   cwd=src, check=True, capture_output=True, timeout=300)
    return next((work / "wheel").glob("*.whl"))


def install_wheel(wheel: Path, target: Path) -> None:
    subprocess.run([sys.executable, *PIP, "install", "--no-deps",
                    "--no-index", "--target", str(target), str(wheel)],
                   check=True, capture_output=True, timeout=300)


def dockerfile_recipe(path: Path = DOCKERFILE) -> dict:
    """The image's own lines: its ENV (name -> value), the RUN line that
    builds the kernels and its CMD, each as an argument list whose
    `python3` is this interpreter (the image's python3 is the one its
    packages are installed for)."""
    env, build, cmd = {}, None, None
    for line in Path(path).read_text().splitlines():
        if line.startswith("ENV "):
            k, v = line[4:].split("=", 1)
            env[k.strip()] = v.strip()
        elif line.startswith("RUN ") and "legslam_torch._build" in line:
            build = shlex.split(line[4:])
        elif line.startswith("CMD "):
            cmd = json.loads(line[4:])
    if build is None or cmd is None:
        raise ValueError(f"{path}: no build RUN line or CMD")

    def host(argv):
        return [sys.executable if a == "python3" else a for a in argv]
    return dict(env=env, build=host(build), cmd=host(cmd))


def _ask(url, body):
    """_http's POST, an HTTP error raised with the server's answer."""
    import urllib.error
    try:
        return _http(url, body)
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{url}: HTTP {e.code}: "
                           f"{e.read()[:2000].decode(errors='replace')}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_health(url: str, proc, timeout_s: float) -> dict:
    """/health's reply once the server answers; raises if the process
    exits or the time runs out."""
    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            return _http(url + "/health")[0]
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode}")
            if time.perf_counter() > deadline:
                raise TimeoutError(f"no /health in {timeout_s} s")
            time.sleep(0.2)


def mapped_files(pid: int) -> set[str]:
    """The files mapped into process `pid` (/proc/<pid>/maps)."""
    with open(f"/proc/{pid}/maps") as f:
        return {line.split(None, 5)[5].strip() for line in f
                if len(line.split(None, 5)) == 6}


def deploy_phase(card, fails, served: dict, rls: dict) -> dict:
    """Phase 13: the port as a user deploys it, outside the checkout.
    A wheel of the tree built with pip and installed with --target into a
    temporary directory; then, from a cwd outside the repository with
    PYTHONPATH at that target, Dockerfile.torch's ENV and
    LEGSLAM_TORCH_BUILD_DIR at a fresh directory: (a) the Dockerfile's
    build RUN line, parsed from the file, builds the kernels and the
    tracking core from the installed sources, and the kernels' libraries
    carry the in-tree build's hashed names (the sources are byte for byte
    the checkout's); (b) the file's CMD (port appended) serves, timed to
    its first /health; (c) POST /find_objects with phase 7's PLY and
    category embedding answers what phase 7's in-process server answered;
    (d) POST /run_legs_slam on phase 12's layout, twice (the first request
    of a fresh process, then a warm one), completes each time with its
    metrics within EVAL_RTOL of phase 12's in-process run (ate within
    ATE_GT) and, by the reply's kernel_launches (the server's own
    counts while the request ran), the forward and backward kernels and
    every other kernel that phase 12's request launched launched in the
    server; (e) the server's /proc/<pid>/maps
    holds the three kernel libraries of the fresh directory and nothing
    of the checkout's build/legslam_torch/. The server is stopped
    whatever happens. Returns the first request's kernel launches."""
    from legslam_torch import _build
    work = Path(tempfile.mkdtemp(prefix="legslam_deploy_")).resolve()
    proc, launches = None, {}
    try:
        t0 = time.perf_counter()
        target = work / "site"
        wheel = build_wheel(work)
        install_wheel(wheel, target)
        pkg_s = time.perf_counter() - t0
        csrc = sorted(p.name for p in _build.CSRC.iterdir())
        shipped = [n for n in csrc if (target / "legslam_torch" / "csrc" / n)
                   .read_bytes() == (_build.CSRC / n).read_bytes()]
        if shipped != csrc:
            fails.append(f"deploy: the wheel holds {shipped} of {csrc}")

        recipe = dockerfile_recipe()
        fresh = work / "build"
        run_dir = work / "run"
        run_dir.mkdir()
        # the image's settings of the program (its PATH is the image's own)
        env = dict(os.environ, **{k: v for k, v in recipe["env"].items()
                                  if k.startswith("LEGSLAM_")})
        env.update(PYTHONPATH=str(target), LEGSLAM_TORCH_BUILD_DIR=str(fresh))
        origin = subprocess.run(
            [sys.executable, "-c",
             "import legslam_torch; print(legslam_torch.__file__)"],
            cwd=run_dir, env=env, capture_output=True, text=True,
            timeout=120).stdout.strip()
        if not origin.startswith(str(target)):
            fails.append(f"deploy: legslam_torch imported from {origin!r}")

        # (a) the image's build line
        t0 = time.perf_counter()
        out = subprocess.run(recipe["build"], cwd=run_dir, env=env,
                             capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        built = dict(line.rsplit(" ", 2)[:2] for line in
                     out.stdout.splitlines() if line.endswith(" s"))
        want = {n: _build._target(n).name for n in CUDA_KERNELS}
        got = {n: Path(p).name for p in built
               for n in CUDA_KERNELS if Path(p).name.startswith(n + "-")}
        libs = {n: fresh / want[n] for n in CUDA_KERNELS}
        by_target = {Path(p).name: float(t) for p, t in built.items()}
        print(f"[deploy] wheel {wheel.name} built and installed with pip "
              f"--target in {pkg_s:.1f} s, csrc {len(shipped)}/{len(csrc)} "
              f"files byte for byte; Dockerfile.torch's build line "
              f"{shlex.join(recipe['build'][1:])!r} from the installed "
              f"package: rc {out.returncode}, {build_s:.1f} s wall (nvcc and "
              f"g++ by target: {by_target} s)"
              f", kernel names equal to the in-tree build's: {got == want} "
              f"[{card}]")
        if out.returncode != 0 or got != want or \
                not all(p.exists() for p in libs.values()):
            fails.append(f"deploy: build line rc {out.returncode}, names "
                         f"{got} vs in-tree {want}: {out.stderr[-2000:]}")
            return launches

        # (b) the image's CMD
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        with open(work / "server.log", "wb") as log:
            proc = subprocess.Popen(recipe["cmd"] + ["--port", str(port)],
                                    cwd=run_dir, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        health = wait_health(url, proc, 300)
        start_s = time.perf_counter() - t0

        # (c) /find_objects on phase 7's map
        reply, find_ms = _ask(url + "/find_objects", {
            "text_emb": served["text_emb"], "query": QUERY_CATEGORY,
            "ply_path": str(Path(served["ply"]).resolve())})
        same_find = reply == served["reply"]

        # (d) /run_legs_slam on phase 12's layout: cold, then warm
        ref, runs = rls["metrics"], []
        for i in range(2):
            answer, ms = _ask(url + "/run_legs_slam", {
                "dataset_path": str(Path(rls["dataset_path"]).resolve()),
                "output_path": str(work / f"run_legs_slam_{i}"),
                "max_frames": rls["max_frames"]})
            m = answer.get("metrics", {})
            gaps = {k: abs(m.get(k, math.nan) - ref[k]) /
                    max(abs(ref[k]), 1e-12)
                    for k in ("frames", "psnr", "ssim", "depth_l1_cm",
                              "n_gaussians")}
            ok = answer.get("status") == "completed" and \
                all(v <= EVAL_RTOL for v in gaps.values()) and \
                all(abs(m.get(k, math.nan)) <= ATE_GT
                    for k in ("ate_rmse", "ate_mean"))
            n = answer.get("kernel_launches") or {}
            unlaunched = [k for k, v in rls["launches"].items()
                          if k in SERVER_KERNELS
                          and (v > 0 or k in ("composite_fwd",
                                              "composite_bwd"))
                          and not n.get(k, 0) > 0]
            runs.append(dict(answer=answer, ms=ms, gaps=gaps, ok=ok,
                             launches=n, unlaunched=unlaunched))
        launches = runs[0]["launches"]

        # (e) what the server has mapped
        maps = mapped_files(proc.pid)
        mapped = {n: str(p) in maps for n, p in libs.items()}
        in_tree = sorted(f for f in maps if f.startswith(
            str(REPO / "build" / "legslam_torch")))
        print(f"[deploy] Dockerfile.torch's CMD "
              f"{shlex.join(recipe['cmd'][1:])!r} + --port {port}: /health "
              f"{health} after {start_s:.1f} s; POST /find_objects (phase "
              f"7's PLY, '{QUERY_CATEGORY}' text_emb) {find_ms:.1f} ms, equal "
              f"to phase 7's in-process reply: {same_find}; kernel "
              f"libraries mapped from the fresh build dir {mapped}, from "
              f"the checkout's build/legslam_torch {in_tree} (host clock) "
              f"[{card}]")
        for name, r in zip(("cold", "warm"), runs):
            m = r["answer"].get("metrics", {})
            shown = {k: m.get(k) for k in (*r["gaps"], "fps",
                                           "total_time_s")}
            print(f"[deploy] POST /run_legs_slam (max_frames "
                  f"{rls['max_frames']}), the server's {name} request: "
                  f"{r['ms']:.1f} ms, status {r['answer'].get('status')}, "
                  f"metrics {shown}, relative gaps to phase 12's "
                  f"{ {k: float(f'{v:.3g}') for k, v in r['gaps'].items()} }"
                  f" (gate {EVAL_RTOL}); the server's kernel launches "
                  f"{r['launches']} (phase 12's in process "
                  f"{rls['launches']}) (host clock) [{card}]")
        if not same_find:
            fails.append(f"deploy: /find_objects {reply} vs phase 7's "
                         f"{served['reply']}")
        for name, r in zip(("cold", "warm"), runs):
            if not r["ok"]:
                fails.append(f"deploy: {name} /run_legs_slam {r['answer']} "
                             f"vs phase 12's {ref}")
            if r["unlaunched"]:
                fails.append(f"deploy: {name} /run_legs_slam launched no "
                             f"{r['unlaunched']} in the server: "
                             f"{r['launches']}")
        if not all(mapped.values()) or in_tree:
            fails.append(f"deploy: mapped kernel libraries {mapped}, "
                         f"in-tree {in_tree}")
    except Exception:
        log = work / "server.log"
        if log.exists():
            print(f"[deploy] server log: {log.read_text()[-4000:]}",
                  file=sys.stderr)
        raise
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    return launches


def build_phase():
    from legslam_torch import _build
    names = CUDA_KERNELS
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
            elif n == "prologue":
                form = "bwd" if "bwd_kernel" in line else "fwd"
                print(f"[build] prologue {form}: {tail}")
            elif n == "sgm" and ("census" in line or "IhLi4E" in line):
                # the cell's instantiations: 8-bit paths, 4 disparities a
                # lane (128)
                form = next(k for k in ("census", "aggregate", "winner")
                            if k in line)
                print(f"[build] sgm {form}: {tail}")
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
    from legslam_torch.ops.cuda import prologue as pr
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
                        sort_keys=cs.sort_keys, sort_kv=cs.sort_kv,
                        prologue_fwd=pr.prologue_forward,
                        prologue_bwd=pr.prologue_backward)
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
          f"(3 fresh binnings), prologue fwd {launches['prologue_fwd']} bwd "
          f"{launches['prologue_bwd']}; group ms "
          f"{[round(x, 2) for x in group_ms]}; "
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
    # the prologue: one forward a render and a fresh binning, one backward
    # a step
    for k, want in (("prologue_fwd", steps + 3), ("prologue_bwd", steps)):
        if launches[k] != want:
            fails.append(f"main: {k} launched {launches[k]} times in "
                         f"{steps} steps and 3 fresh binnings")

    # the kernels against their plain versions on the first step's inputs,
    # the same in every run; the trained store is not (float atomics add in
    # no fixed order), and the termination flips it meets may land on a
    # pair at the 0.99 alpha clamp, whose pixel ends at T = 1e-2 within
    # rounding, the bound of check_kernels' exemption
    first = StepLoop(st0, view, gt, make_cfg(1 << 20, "bfloat16"))
    seen = {}
    binning0 = first._binning()
    fa, ba = capture_kernel_inputs(lambda: seen.update(pro=(
        capture_prologue_inputs(lambda: first.step(binning0)))))
    errs = check_kernels(fa, ba, "1200x680 bf16", card, fails)
    pro_errs = check_prologue(*seen["pro"], "1200x680", card, fails)
    del first, st0, binning0
    # timed on a reuse step's inputs
    fa, ba = capture_kernel_inputs(lambda: seen.update(pro=(
        capture_prologue_inputs(lambda: drv.step(drv.binning)))))
    pfa, pba = seen.pop("pro")
    pro_b = prologue_bound(pfa)
    with ClockSampler() as clk_pro:
        pro_times = dict(
            fwd=event_ms(lambda: pr.prologue_forward(*pfa), 50),
            bwd=event_ms(lambda: pr.prologue_backward(*pba), 50))
    pro_times.update(
        fwd_plain=event_ms(lambda: pr.prologue_forward_plain(*pfa), 5),
        bwd_plain=event_ms(lambda: pr.prologue_backward_plain(*pba), 5))
    print(f"[prologue] times at 1200x680 ({int(pfa[5])} of "
          f"{int(pfa[0].shape[0])} rows, SH degree {pfa[10]}, LF "
          f"{pfa[8].shape[1]}): fwd {pro_times['fwd']:.4f} ms (plain "
          f"{pro_times['fwd_plain']:.3f}, bound "
          f"{pro_b['fwd']['bound_ms']:.4f} by {pro_b['fwd']['bound_by']}); "
          f"bwd {pro_times['bwd']:.4f} ms (plain "
          f"{pro_times['bwd_plain']:.3f}, bound "
          f"{pro_b['bwd']['bound_ms']:.4f} by {pro_b['bwd']['bound_by']}) "
          f"[{card}]")
    print(f"[clocks] prologue timing: {clk_pro.summary()} [{card}]")
    del pfa, pba
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
    torch.cuda.empty_cache()
    phase_s["system"] = time.perf_counter() - t_phase

    # phase 7: the query and serving stack
    t_phase = time.perf_counter()
    query_launches, served = query_phase(dev, card, fails,
                                         Path(str(out_dir) + "_query"), pca)
    phase_s["query"] = time.perf_counter() - t_phase

    # phase 8: the visual tracking frontend, SGM stereo, mono, the viewer;
    # the tracker takes its native route (the port's C++ core, built with
    # g++ from the checkout) whether or not cv2 is installed
    os.environ["LEGSLAM_NATIVE_TRACKING"] = "1"
    t_phase = time.perf_counter()
    fe, vis_mapper, visual_launches = visual_phase(
        dev, card, fails, str(out_dir) + "_visual", enc)
    phase_s["visual"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    viewer_phase(dev, card, fails, fe, vis_mapper)
    del fe, vis_mapper
    torch.cuda.empty_cache()
    phase_s["viewer"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    stereo_phase(dev, card, fails, str(out_dir) + "_stereo")
    phase_s["stereo"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    mono_phase(dev, card, fails, str(out_dir) + "_mono")
    phase_s["mono"] = time.perf_counter() - t_phase

    # phase 9: the bucketed layout, strips, views, the slab skip, the cull
    t_phase = time.perf_counter()
    st, view, gt = make_scene(dev, 1200, 680, 200_000, 1 << 18, seed=0)
    bucketed = bucket_phase(dev, card, fails, st, view, gt)
    strips_phase(dev, card, fails, st, view, gt, ds, frames,
                 str(out_dir) + "_strips")
    multiview_phase(dev, card, fails, st, view, gt, ds, frames,
                    str(out_dir) + "_views")
    slabs_cull_phase(dev, card, fails, st, view, gt, ds, frames,
                     str(out_dir) + "_slabs")
    store_phase(dev, card, fails, ds)
    del st, view, gt
    torch.cuda.empty_cache()
    phase_s["phase9"] = time.perf_counter() - t_phase

    # phase 10: a capacity rung crossed and loop-closure surgery, on the card
    t_phase = time.perf_counter()
    ladder_launches = ladder_phase(dev, card, fails, ds, frames,
                                   str(out_dir) + "_ladder")
    del ds, frames
    torch.cuda.empty_cache()
    loop_phase(dev, card, fails, str(out_dir) + "_loop")
    phase_s["phase10"] = time.perf_counter() - t_phase

    # phase 11: the lens-distorted camera and the inertial sensor modes
    t_phase = time.perf_counter()
    undistort_launches = undistort_phase(dev, card, fails,
                                         str(out_dir) + "_undistort")
    torch.cuda.empty_cache()
    phase_s["undistort"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    inertial_launches = inertial_phase(dev, card, fails,
                                       str(out_dir) + "_inertial")
    torch.cuda.empty_cache()
    phase_s["inertial"] = time.perf_counter() - t_phase

    # phase 12: the evaluation harnesses, /run_legs_slam, the offline
    # trainer, the detection CLI and the autoencoder
    t_phase = time.perf_counter()
    eval_launches, rls = evaluation_phase(dev, card, fails,
                                          str(out_dir) + "_evaluation", enc)
    del enc
    torch.cuda.empty_cache()
    phase_s["evaluation"] = time.perf_counter() - t_phase

    # phase 13: the wheel, the image's build line and its server
    t_phase = time.perf_counter()
    deploy_launches = deploy_phase(card, fails, served, rls)
    phase_s["deploy"] = time.perf_counter() - t_phase
    print(f"[phases] seconds {({k: round(v, 1) for k, v in phase_s.items()})}"
          f", total {sum(phase_s.values()):.1f} [{card}]")

    rows = []
    for k, name, src, tpu in (
            ("fwd", "composite_fwd", "legslam_torch/csrc/composite_fwd.cu",
             "legslam_tpu/ops/pallas/composite.py:153"),
            ("bwd", "composite_bwd", "legslam_torch/csrc/composite_bwd.cu",
             "legslam_tpu/ops/pallas/composite_bwd.py:96")):
        bt = bucketed["times"]
        rows.append(dict(name=name, route="cuda", source=src, replaces=tpu,
                         launches=launches[k],
                         query_launches=query_launches[name],
                         visual_launches=visual_launches[name],
                         ladder_launches=ladder_launches[name],
                         undistort_launches=undistort_launches[name],
                         inertial_launches=inertial_launches[name],
                         eval_launches=eval_launches[name],
                         deploy_launches=deploy_launches.get(name, 0),
                         max_abs_err=errs[k],
                         ms=times[k], plain_ms=times[f"{k}_plain"],
                         bound_ms=b[k]["bound_ms"],
                         bound_by=b[k]["bound_by"], library_ms=None,
                         bucketed_launches=bucketed["launches"][k],
                         bucketed_max_abs_err=bucketed["errs"][k],
                         bucketed_ms=bt[k], bucketed_flat_ms=bt[f"{k}_flat"],
                         bucketed_plain_ms=bt[f"{k}_plain"],
                         bucketed_bound_ms=bucketed["bounds"][k]["bound_ms"],
                         bucketed_bound_by=bucketed["bounds"][k]["bound_by"]))
    for k, name in (("fwd", "prologue_fwd"), ("bwd", "prologue_bwd")):
        rows.append(dict(name=name, route="cuda",
                         source="legslam_torch/csrc/prologue.cu",
                         replaces=None, launches=launches[name],
                         query_launches=query_launches[name],
                         visual_launches=visual_launches[name],
                         ladder_launches=ladder_launches[name],
                         undistort_launches=undistort_launches[name],
                         inertial_launches=inertial_launches[name],
                         eval_launches=eval_launches[name],
                         deploy_launches=None,
                         max_abs_err=pro_errs[k], ms=pro_times[k],
                         plain_ms=pro_times[f"{k}_plain"],
                         bound_ms=pro_b[k]["bound_ms"],
                         bound_by=pro_b[k]["bound_by"], library_ms=None))
    for name, tpu in (("sort_keys", "legslam_tpu/ops/pallas/sort.py:111"),
                      ("sort_kv", "legslam_tpu/ops/pallas/sort.py:116")):
        rows.append(dict(name=name, route="cuda",
                         source="legslam_torch/csrc/sort.cu", replaces=tpu,
                         launches=mapper_launches[name],
                         query_launches=query_launches[name],
                         visual_launches=visual_launches[name],
                         ladder_launches=ladder_launches[name],
                         undistort_launches=undistort_launches[name],
                         inertial_launches=inertial_launches[name],
                         eval_launches=eval_launches[name],
                         deploy_launches=deploy_launches.get(name, 0),
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
