"""Backward compositing kernel and the autograd pairing with the forward.

Counterpart of legslam_tpu/ops/pallas/composite_bwd.py. The kernel is CUDA
C++ for sm_90a (legslam_torch/csrc/composite_bwd.cu); `composite_backward`
launches it for CUDA tensors and runs `composite_backward_plain`, its plain
PyTorch version, for CPU tensors. `CompositeTiles` pairs it with the
forward kernel as make_composite_vjp does in the JAX package; the
pair -> gaussian reduction is the scatter-add backward of the pair gather
(ops/cuda/composite.py prepare_pairs).

Gradient contract (ops/composite.py): straight-through on the 0.99 alpha
clamp (backward.cu:591-607), hard masks for the skip rules and the
termination, and the background coupling dL/dalpha += -T_final/(1-alpha)
* <bg, dL/dpixel> (backward.cu:598-603) arriving as the t_final cotangent.
"""
from __future__ import annotations

import ctypes

import torch

from legslam_torch.ops.cuda.composite import (
    GEO_A,
    GEO_B,
    GEO_C,
    GEO_OP,
    GEO_ROWS,
    GEO_X,
    GEO_Y,
    LOG_TERM,
    PLAIN_TILE_BATCH,
    check_kernel_shape,
    check_pairs,
    chunk_alpha,
    composite_forward,
    exclusive_cumsum,
    kernel_args,
    tile_chunk_ranges,
    tile_pixels,
)


def _check_grads(start, geo, feats, gout, gtfin, tfin, acc, npix: int,
                 n_buckets: int):
    ntiles, nch = start.shape[0] // n_buckets, feats.shape[1]
    for name, x, shape in (("gout", gout, (ntiles, npix, nch)),
                           ("acc", acc, (ntiles, npix, nch)),
                           ("gtfin", gtfin, (ntiles, npix)),
                           ("tfin", tfin, (ntiles, npix))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or \
                x.device != geo.device:
            raise ValueError(f"{name} must be {shape} float32 on "
                             f"{geo.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def composite_backward(start: torch.Tensor, count: torch.Tensor,
                       geo: torch.Tensor, feats: torch.Tensor,
                       gout: torch.Tensor, gtfin: torch.Tensor,
                       tfin: torch.Tensor, acc: torch.Tensor, tile_w: int,
                       tile_h: int, ntx: int, chunk: int, n_buckets: int = 1):
    """Per-pair gradients of the forward compositing: returns
    (dgeo [N, 8] f32, dfeats [N, C] f32) from gout = dL/dacc and
    gtfin = dL/dt_final, given the forward's t_final and acc; start/count
    hold n_buckets ranges a tile, walked in order. Launches the CUDA
    kernel for CUDA tensors (counted in `composite_backward.launches`)
    and runs the plain version for CPU tensors."""
    dev = check_pairs(start, count, geo, feats, tile_w, chunk, n_buckets)
    _check_grads(start, geo, feats, gout, gtfin, tfin, acc, tile_w * tile_h,
                 n_buckets)
    if dev.type == "cpu":
        return composite_backward_plain(start, count, geo, feats, gout,
                                        gtfin, tfin, acc, tile_w, tile_h,
                                        ntx, chunk, n_buckets)
    if dev.type != "cuda":
        raise ValueError(f"no compositing kernel for device {dev}")
    nch = feats.shape[1]
    check_kernel_shape(nch, tile_h)
    dgeo = torch.zeros(geo.shape[0], GEO_ROWS, dtype=torch.float32,
                       device=dev)
    dfeats = torch.zeros(geo.shape[0], nch, dtype=torch.float32, device=dev)
    fn = _bwd_fn()
    ptrs = kernel_args(start, count, geo, feats, gout, gtfin, tfin, acc,
                       dgeo, dfeats)
    err = fn(*ptrs[:4], int(feats.dtype == torch.bfloat16), nch,
             start.shape[0] // n_buckets, n_buckets, tile_w, tile_h, ntx,
             *ptrs[4:], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_bwd launch failed: error {err}")
    composite_backward.launches += 1
    return dgeo, dfeats


composite_backward.launches = 0


def _bwd_fn():
    from legslam_torch import _build
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.function("composite_bwd", "legslam_composite_bwd",
                           [vp, vp, vp, vp, i, i, i, i, i, i, i,
                            vp, vp, vp, vp, vp, vp, vp])


@torch.no_grad()
def composite_backward_plain(start, count, geo, feats, gout, gtfin, tfin,
                             acc, tile_w: int, tile_h: int, ntx: int,
                             chunk: int, n_buckets: int = 1):
    """Plain PyTorch version of the backward kernel, same arguments and
    outputs, with the analytic formulas of
    legslam_tpu/ops/pallas/composite_bwd.py:246-315 per chunk of pairs,
    the bucket ranges of a tile in order with the pixel state carried
    across them: suffix sums S_k = <gout, acc> - inclusive prefix of
    dw*w, dalpha = dw*T - (S_k + gT*T_final)/(1 - alpha) on composited
    pairs (zero on all others), and the geometry gradients as pixel
    moments of dG = exp(power) * dalpha in pair-centered coordinates."""
    ntiles, npix = start.shape[0] // n_buckets, tile_w * tile_h
    dev = geo.device
    n = geo.shape[0]
    feats = feats.float()
    dgeo = torch.zeros(n, GEO_ROWS, device=dev)
    dfeats = torch.zeros(n, feats.shape[1], device=dev)
    koff = torch.arange(chunk, device=dev)
    for t0 in range(0, ntiles, PLAIN_TILE_BATCH):
        tid = torch.arange(t0, min(t0 + PLAIN_TILE_BATCH, ntiles),
                           device=dev)
        px, py = tile_pixels(tid, tile_w, tile_h, ntx)
        g_out = gout[tid]
        stot = torch.sum(g_out * acc[tid], dim=-1)          # [B, npix]
        gt_term = (gtfin[tid] * tfin[tid])[..., None]
        log_all = torch.zeros(len(tid), npix, device=dev)
        s_prefix = torch.zeros_like(log_all)
        alive = torch.ones(len(tid), dtype=torch.bool, device=dev)
        for b in range(n_buckets):
            rid = tid * n_buckets + b
            s, e, base0, n_chunks = tile_chunk_ranges(start[rid],
                                                      count[rid], chunk)
            running = alive & (n_chunks > 0)
            for k in range(int(n_chunks.max())):
                running = running & (k < n_chunks)
                pos = base0[:, None] + k * chunk + koff
                in_range = (pos >= s[:, None]) & (pos < e[:, None]) & \
                    running[:, None]
                a = chunk_alpha(geo, pos, in_range, px, py)
                alpha = a["alpha"]
                log1m = torch.log1p(-alpha)
                log_exc = log_all[..., None] + exclusive_cumsum(log1m)
                # skipped pairs (keep False) have alpha 0 and get no
                # gradient
                contrib = (log_exc + log1m >= LOG_TERM) & a["keep"]
                t_exc = torch.exp(log_exc)
                w = torch.where(contrib, alpha * t_exc, 0.0)
                f = feats[torch.clamp(pos, 0, n - 1)]        # [B, chunk, C]
                dw = torch.bmm(g_out, f.transpose(1, 2))     # [B, npix, chunk]
                q = dw * w
                s_k = stot[..., None] - (s_prefix[..., None]
                                         + torch.cumsum(q, dim=-1))
                dalpha = torch.where(
                    contrib, dw * t_exc - (s_k + gt_term) / (1.0 - alpha),
                    0.0)
                dg = a["g_exp"] * dalpha
                dx, dy = a["dx"], a["dy"]
                m0, mx, my = dg.sum(1), (dg * dx).sum(1), (dg * dy).sum(1)
                mxx = (dg * dx * dx).sum(1)
                myy = (dg * dy * dy).sum(1)
                mxy = (dg * dx * dy).sum(1)
                g = a["g"]
                op, ca, cb, cc = g[..., GEO_OP], g[..., GEO_A], \
                    g[..., GEO_B], g[..., GEO_C]
                sx, sy = op * mx, op * my
                rows = torch.zeros(*pos.shape, GEO_ROWS, device=dev)
                rows[..., GEO_X] = -(ca * sx) - cb * sy
                rows[..., GEO_Y] = -(cc * sy) - cb * sx
                rows[..., GEO_A] = -0.5 * op * mxx
                rows[..., GEO_B] = -op * mxy
                rows[..., GEO_C] = -0.5 * op * myy
                rows[..., GEO_OP] = m0
                df = torch.bmm(w.transpose(1, 2), g_out)     # [B, chunk, C]
                # each position belongs to exactly one tile and one chunk
                dgeo[pos[in_range]] = rows[in_range]
                dfeats[pos[in_range]] = df[in_range]
                log_all = log_all + log1m.sum(-1)
                s_prefix = s_prefix + q.sum(-1)
                newly = running & (log_all.max(-1).values < LOG_TERM)
                running = running & ~newly
                alive = alive & ~newly
    return dgeo, dfeats


class CompositeTiles(torch.autograd.Function):
    """Differentiable tile compositing: forward kernel + backward kernel.

    apply(start, count, geo, feats, tile_w, tile_h, ntx, chunk, n_buckets)
    -> (acc, t_final, kfin); gradients flow to geo and feats in pair
    space, kfin is an int32 watermark without gradient (None when
    n_buckets > 1)."""

    @staticmethod
    def forward(ctx, start, count, geo, feats, tile_w, tile_h, ntx, chunk,
                n_buckets=1):
        acc, tfin, kfin = composite_forward(start, count, geo, feats,
                                            tile_w, tile_h, ntx, chunk,
                                            n_buckets)
        ctx.save_for_backward(start, count, geo, feats, tfin, acc)
        ctx.meta = (tile_w, tile_h, ntx, chunk, n_buckets)
        if kfin is not None:
            ctx.mark_non_differentiable(kfin)
        return acc, tfin, kfin

    @staticmethod
    def backward(ctx, dacc, dtfin, _dkfin):
        start, count, geo, feats, tfin, acc = ctx.saved_tensors
        dgeo, dfeats = composite_backward(
            start, count, geo, feats, dacc.contiguous(), dtfin.contiguous(),
            tfin, acc, *ctx.meta)
        # the pair feature gradient takes the features' storage type, as
        # the JAX package's bf16 pair cotangent does
        return (None, None, dgeo, dfeats.to(feats.dtype), None, None, None,
                None, None)
