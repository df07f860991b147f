"""Forward compositing kernel and the pair staging around it.

Counterpart of legslam_tpu/ops/pallas/composite.py. The kernel is CUDA C++
for sm_90a (legslam_torch/csrc/composite_fwd.cu); `composite_forward`
launches it for CUDA tensors and runs `composite_forward_plain`, its plain
PyTorch version, for CPU tensors.

Pair layout (chosen for the GPU; the TPU kernels used [8, N] rows for
their lanes): geometry rows [N, 8] f32 = (x, y, conic a, b, c, opacity,
0, 0), 32 bytes a pair; features [N, C_pad] in the mm_dtype, C_pad = C
rounded up to a multiple of 8, so every pair row of bf16 features and
every pixel row of the f32 accumulator is a whole number of 16-byte
vectors (the TPU padded 68 to 128 lanes).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from legslam_torch.config import ALPHA_MAX, ALPHA_MIN, T_TERMINATE
from legslam_torch.utils import runtime

GEO_X, GEO_Y, GEO_A, GEO_B, GEO_C, GEO_OP = range(6)
GEO_ROWS = 8
LOG_TERM = math.log(T_TERMINATE)
# pairs the forward kernel stages per batch; a chunk must hold whole batches
KERNEL_BATCH = 32
# the channel widths the kernels are compiled for, and their pixels per
# block (composite_common.cuh)
KERNEL_WIDTHS = (8, 72)
KERNEL_THREADS = 256
# tiles per batch of the plain versions (bounds their [B, npix, chunk]
# intermediates)
PLAIN_TILE_BATCH = 32


def padded_channels(c: int) -> int:
    return -(-c // 8) * 8


# rows the backward scatter spreads the sentinel pairs over (their
# gradients are zero; one drop row would serialise the float atomics of
# every sentinel hole of a bucketed layout on it)
SENTINEL_ROWS = 1024


class _TakePairs(torch.autograd.Function):
    """Gather pair geometry and features in sorted (tile, depth) order; the
    backward scatter-adds the pair gradients onto the gaussians in f32.
    Sentinel ids (gid == P) only sit outside every tile's range: the
    forward reads row P-1 for them, the backward drops them onto
    SENTINEL_ROWS spare rows."""

    @staticmethod
    def forward(ctx, geo_g, feats, gid, feat_dtype):
        P = geo_g.shape[0]
        idx = torch.clamp_max(gid, P - 1).long()
        ctx.save_for_backward(gid)
        ctx.P = P
        return (geo_g.index_select(0, idx),
                feats.to(feat_dtype).index_select(0, idx))

    @staticmethod
    def backward(ctx, dgeo, dpf):
        (gid,) = ctx.saved_tensors
        idx = gid.long()
        pos = torch.arange(idx.shape[0], device=idx.device)
        idx = torch.where(idx < ctx.P, idx, ctx.P + pos % SENTINEL_ROWS)

        def scatter(d):
            out = torch.zeros(ctx.P + SENTINEL_ROWS, d.shape[1],
                              dtype=torch.float32, device=d.device)
            return out.index_add_(0, idx, d.float())[:ctx.P]
        return scatter(dgeo), scatter(dpf), None, None


def prepare_pairs(binning, mean2d: torch.Tensor, conic: torch.Tensor,
                  opacity: torch.Tensor, feats: torch.Tensor,
                  max_pairs: int, mm_dtype: str = "float32",
                  n_buckets: int = 1):
    """Per-pair geometry and features in sorted (tile, depth) order.

    Flat Binning (n_buckets 1): valid pairs occupy the front of the sorted
    binning arrays, so truncating at `max_pairs` keeps them all while
    num_rendered <= max_pairs; overflowing tiles are clipped at the range
    level. The sentinel tail is cut too (one host read of num_rendered per
    call): its rows are never read for a tile, and scatter-adding their
    zero gradients would serialize on one row.

    BucketedBinning (n_buckets > 1, legslam_tpu/ops/pallas/composite.py:
    451-457): the pair ids are already capped per bucket, and the ranges
    are the flat [ntiles * B] view of [ntiles, B]. The valid pairs are
    per-bucket prefixes with sentinel holes between them, so nothing is
    cut and no global max_pairs clip applies.

    Returns (start [ntiles * B] i32, count [ntiles * B] i32, geo [N, 8]
    f32, pair_feats [N, C_pad] in mm_dtype); N = min(max_pairs,
    num_rendered), at least 1, in the flat layout, and B * bucket_cap in
    the bucketed one.
    """
    if n_buckets > 1:
        gid = binning.pair_gid
        start = binning.tile_start.reshape(-1).to(torch.int32)
        count = binning.tile_count.reshape(-1).to(torch.int32)
    else:
        n = max(1, min(max_pairs, int(binning.num_rendered)))
        gid = binning.pair_gid[:n]
        start = torch.clamp_max(binning.tile_start, max_pairs).to(
            torch.int32)
        end = torch.clamp_max(binning.tile_start + binning.tile_count,
                              max_pairs)
        count = (end - start).to(torch.int32)
    zeros = torch.zeros_like(opacity)
    geo_g = torch.stack([mean2d[:, 0], mean2d[:, 1], conic[:, 0],
                         conic[:, 1], conic[:, 2], opacity, zeros, zeros],
                        dim=1)
    c = feats.shape[1]
    feats = F.pad(feats, (0, padded_channels(c) - c))
    dtype = torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32
    geo, pf = _TakePairs.apply(geo_g, feats, gid, dtype)
    return start, count, geo, pf


def check_pairs(start, count, geo, feats, tile_w: int, chunk: int,
                n_buckets: int = 1):
    """Validate the pair arrays a compositing kernel or its plain version
    is given; returns the device."""
    dev = geo.device
    for name, x in (("start", start), ("count", count), ("feats", feats)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, geo on {dev}")
    if start.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError("start/count must be int32")
    if start.shape != count.shape or start.ndim != 1:
        raise ValueError("start/count must be matching [ntiles] vectors")
    if n_buckets < 1 or start.shape[0] % n_buckets:
        raise ValueError(f"{start.shape[0]} ranges are not whole tiles of "
                         f"{n_buckets} buckets")
    if geo.dtype != torch.float32 or geo.ndim != 2 or \
            geo.shape[1] != GEO_ROWS:
        raise ValueError(f"geo must be [N, {GEO_ROWS}] float32")
    if feats.ndim != 2 or feats.shape[0] != geo.shape[0] or \
            feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("feats must be [N, C] float32 or bfloat16")
    if chunk % KERNEL_BATCH or chunk <= 0 or tile_w <= 0:
        raise ValueError(f"chunk must be a multiple of {KERNEL_BATCH}")
    return dev


def check_kernel_shape(nch: int, tile_h: int):
    """Raise for a feature width or tile height the kernels do not take."""
    if nch not in KERNEL_WIDTHS:
        raise ValueError(f"feature width {nch} not in {KERNEL_WIDTHS}")
    if KERNEL_THREADS % tile_h:
        raise ValueError(f"tile_h {tile_h} must divide {KERNEL_THREADS}")


def kernel_args(*tensors):
    """data_ptr()s of contiguous, 16-byte aligned CUDA tensors."""
    ptrs = []
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
        ptrs.append(x.data_ptr())
    return ptrs


def composite_forward(start: torch.Tensor, count: torch.Tensor,
                      geo: torch.Tensor, feats: torch.Tensor, tile_w: int,
                      tile_h: int, ntx: int, chunk: int, n_buckets: int = 1):
    """Forward compositing over the pair arrays; start/count hold
    n_buckets ranges a tile (bucket-major per tile), walked in order.

    Returns (acc [ntiles, tile_h*tile_w, C] f32, t_final [ntiles,
    tile_h*tile_w] f32, kfin [ntiles] int32), kfin None when n_buckets > 1
    (the watermark is defined for the flat layout only). Launches the CUDA
    kernel for CUDA tensors (counted in `composite_forward.launches`) and
    runs the plain version for CPU tensors.
    """
    dev = check_pairs(start, count, geo, feats, tile_w, chunk, n_buckets)
    if dev.type == "cpu":
        return composite_forward_plain(start, count, geo, feats, tile_w,
                                       tile_h, ntx, chunk, n_buckets)
    if dev.type != "cuda":
        raise ValueError(f"no compositing kernel for device {dev}")
    nch = feats.shape[1]
    check_kernel_shape(nch, tile_h)
    ntiles, npix = start.shape[0] // n_buckets, tile_w * tile_h
    acc = torch.empty(ntiles, npix, nch, dtype=torch.float32, device=dev)
    tfin = torch.empty(ntiles, npix, dtype=torch.float32, device=dev)
    kfin = torch.zeros(ntiles, dtype=torch.int32, device=dev) \
        if n_buckets == 1 else None
    fn = _fwd_fn()
    p_start, p_count, p_geo, p_feats, p_acc, p_tfin = kernel_args(
        start, count, geo, feats, acc, tfin)
    p_kfin = kfin.data_ptr() if kfin is not None else None
    err = fn(p_start, p_count, p_geo, p_feats,
             int(feats.dtype == torch.bfloat16), nch, ntiles, n_buckets,
             tile_w, tile_h, ntx, chunk, p_acc, p_tfin, p_kfin,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_fwd launch failed: error {err}")
    composite_forward.launches += 1
    return acc, tfin, kfin


composite_forward.launches = 0


def _fwd_fn():
    from legslam_torch import _build
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.function("composite_fwd", "legslam_composite_fwd",
                           [vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                            vp, vp, vp, vp])


def tile_pixels(tile_ids: torch.Tensor, tile_w: int, tile_h: int, ntx: int):
    """Global pixel coordinates [B, npix] (x, y) of a batch of tiles, pixel
    p of a tile at (p % tile_w, p // tile_w)."""
    lin = torch.arange(tile_w * tile_h, device=tile_ids.device)
    px = (tile_ids % ntx)[:, None] * tile_w + lin % tile_w
    py = (tile_ids // ntx)[:, None] * tile_h + lin // tile_w
    return px.float(), py.float()


def chunk_alpha(geo: torch.Tensor, pos: torch.Tensor, in_range: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor) -> dict:
    """Alpha terms of one chunk of pairs for a batch of tiles, as the
    kernels compute them. pos/in_range [B, chunk], px/py [B, npix];
    the [B, npix, chunk] outputs are zero outside the range."""
    g = geo[torch.clamp(pos, 0, geo.shape[0] - 1)]     # [B, chunk, 8]
    gx, gy, ca, cb, cc = (g[..., i][:, None, :] for i in range(5))
    op = torch.where(in_range, g[..., GEO_OP], 0.0)[:, None, :]
    dx = gx - px[:, :, None]
    dy = gy - py[:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g_exp = torch.exp(torch.clamp_max(power, 0.0))
    alpha = torch.clamp_max(op * g_exp, ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return dict(g=g, dx=dx, dy=dy, g_exp=g_exp, keep=keep,
                alpha=torch.where(keep, alpha, 0.0))


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return F.pad(torch.cumsum(x, dim=-1)[..., :-1], (1, 0))


def tile_chunk_ranges(start, count, chunk: int):
    """(start, end, chunk-aligned base, chunk count) of each tile's range,
    int64, in the kernels' unit."""
    s = start.long()
    e = s + count.long()
    base0 = torch.div(s, chunk, rounding_mode="floor") * chunk
    n_chunks = torch.div(e - base0 + chunk - 1, chunk, rounding_mode="floor")
    return s, e, base0, n_chunks


@torch.no_grad()
def composite_forward_plain(start, count, geo, feats, tile_w: int,
                            tile_h: int, ntx: int, chunk: int,
                            n_buckets: int = 1):
    """Plain PyTorch version of the forward kernel, same arguments and
    outputs: per batch of tiles, per bucket range in order and per chunk
    of pairs, alphas for every (pixel, pair), the exclusive
    log-transmittance prefix by cumsum, and the channel sums by a matmul,
    each pixel's state carried from one range to the next. A tile stops
    after the first chunk that leaves every pixel with log T_all <
    log(1e-4); in the flat layout kfin counts its chunks."""
    ntiles, npix = start.shape[0] // n_buckets, tile_w * tile_h
    dev = geo.device
    feats = feats.float()
    acc = torch.zeros(ntiles, npix, feats.shape[1], device=dev)
    tfin = torch.ones(ntiles, npix, device=dev)
    kfin = torch.zeros(ntiles, dtype=torch.int32, device=dev)
    koff = torch.arange(chunk, device=dev)
    for t0 in range(0, ntiles, PLAIN_TILE_BATCH):
        tid = torch.arange(t0, min(t0 + PLAIN_TILE_BATCH, ntiles),
                           device=dev)
        px, py = tile_pixels(tid, tile_w, tile_h, ntx)
        log_all = torch.zeros(len(tid), npix, device=dev)
        log_fin = torch.zeros_like(log_all)
        a = torch.zeros(len(tid), npix, feats.shape[1], device=dev)
        alive = torch.ones(len(tid), dtype=torch.bool, device=dev)
        for b in range(n_buckets):
            rid = tid * n_buckets + b
            s, e, base0, n_chunks = tile_chunk_ranges(start[rid],
                                                      count[rid], chunk)
            running = alive & (n_chunks > 0)
            if b == 0:
                kf = n_chunks.clone()
            for k in range(int(n_chunks.max())):
                running = running & (k < n_chunks)
                pos = base0[:, None] + k * chunk + koff
                in_range = (pos >= s[:, None]) & (pos < e[:, None]) & \
                    running[:, None]
                alpha = chunk_alpha(geo, pos, in_range, px, py)["alpha"]
                log1m = torch.log1p(-alpha)
                log_exc = log_all[..., None] + exclusive_cumsum(log1m)
                contrib = log_exc + log1m >= LOG_TERM
                w = torch.where(contrib, alpha * torch.exp(log_exc), 0.0)
                f = feats[torch.clamp(pos, 0, feats.shape[0] - 1)]
                a = a + torch.bmm(w, f)
                log_all = log_all + log1m.sum(-1)
                log_fin = log_fin + torch.where(contrib, log1m, 0.0).sum(-1)
                newly = running & (log_all.max(-1).values < LOG_TERM)
                if b == 0:
                    kf = torch.where(newly, k + 1, kf)
                running = running & ~newly
                alive = alive & ~newly
        acc[tid] = a
        tfin[tid] = torch.exp(log_fin)
        kfin[tid] = kf.to(torch.int32)
    return acc, tfin, kfin if n_buckets == 1 else None


def composite_image(binning, mean2d, conic, opacity, feats, width: int,
                    height: int, tile_w: int, tile_h: int, max_pairs: int,
                    chunk: int = 256, mm_dtype: str = "float32",
                    n_buckets: int = 1):
    """Full-image compositing through the kernels, differentiable in
    mean2d / conic / opacity / feats (backward kernel + the pair gather's
    scatter-add), over a flat Binning or, with the matching n_buckets, a
    BucketedBinning. Returns (img [H, W, C], t_final [H, W], kfin
    [ntiles]), kfin being the per-tile termination watermark that feeds
    ops/binning.trim_binning (None for a bucketed binning)."""
    from legslam_torch.ops.cuda.composite_bwd import CompositeTiles
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    c = feats.shape[1]
    with runtime.span("render.pairs"):
        start, count, geo, pf = prepare_pairs(binning, mean2d, conic,
                                              opacity, feats, max_pairs,
                                              mm_dtype, n_buckets)
    with runtime.span("render.composite"):
        acc, tfin, kfin = CompositeTiles.apply(start, count, geo, pf,
                                               tile_w, tile_h, ntx, chunk,
                                               n_buckets)
    c_out = acc.shape[-1]
    img = acc.reshape(nty, ntx, tile_h, tile_w, c_out).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile_h, ntx * tile_w, c_out)[:height, :width, :c]
    tf = tfin.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
    tf = tf.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return img, tf, kfin
