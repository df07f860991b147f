"""Tile binning: depth ordering + (gaussian, tile) pair lists + tile ranges.

Replaces the reference's duplicateWithKeys + CUB radix sort +
identifyTileRanges pipeline (cuda_rasterizer/rasterizer_impl.cu:70-138,
280-320) with the same scheme as legslam_tpu/ops/binning.py, so the
outputs are bit-equal:

  1. sort gaussians once by view depth (stable argsort over P),
  2. emit per-gaussian (tile, depth-rank) pairs over a static tile-span
     cap, packed into one int32 key = tile * P + rank (ntiles * P < 2^31,
     checked),
  3. sort the packed keys (invalid pairs get the sentinel ntiles * P and
     sink to the end),
  4. recover per-tile ranges with searchsorted.

Within a tile, ascending key order is ascending depth order
(rasterizer_impl.cu:98-109). bin_gaussians_bucketed is the rank-block
bucketed variant (BucketedBinning). The span-slab switch and
the chunked, cond-skipped id lookups of the JAX version are TPU
workarounds; here the full emission buffer is sorted once and the ids
are looked up with one gather.

With RasterizeConfig.cuda_sort, steps 1 and 3 run on the hand-written
radix sort kernels (ops/cuda/sort.py; legslam_tpu/ops/binning.py:241-245
and :297-312 with pallas_sort): the depth order through argsort_f32, and
the key buffer as it lies through sort_keys, over the bits of the
sentinel only (keys are in [0, sentinel]). Both order ties as a stable
sort does, so the Binning is the same bit for bit with the flag on or off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from legslam_torch.config import ALPHA_MIN, RasterizeConfig
from legslam_torch.ops.projection import Preprocessed


class TileRect(NamedTuple):
    x0: torch.Tensor
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor,
              tile_w: int, tile_h: int, ntx: int, nty: int) -> TileRect:
    """getRect (auxiliary.h:45-57): clamped tile-index rectangle."""
    px, py = mean2d[..., 0], mean2d[..., 1]
    r = radius.to(px.dtype)

    def cell(v, size, n):
        return torch.floor(v / size).clamp(0, n).to(torch.int32)

    return TileRect(cell(px - r, tile_w, ntx),
                    cell(px + r + tile_w - 1, tile_w, ntx),
                    cell(py - r, tile_h, nty),
                    cell(py + r + tile_h - 1, tile_h, nty))


def effective_radius(radius: torch.Tensor, opacity: torch.Tensor
                     ) -> torch.Tensor:
    """Opacity-aware screen radius: the largest distance at which this
    gaussian can still clear the kernels' alpha >= ALPHA_MIN keep mask.

    alpha(d) <= op * exp(-0.5 d^2 / lam_max), so alpha < ALPHA_MIN beyond
    r_eff = sqrt(lam_max) * sqrt(2 ln(op / ALPHA_MIN)); preprocess's
    radius = ceil(3 sqrt(lam_max)) bounds sqrt(lam_max) by radius / 3, so
    the bound is conservative and the cull it drives is render-exact.
    Shrinks to 0 when op <= ALPHA_MIN."""
    ratio = torch.log(torch.clamp_min(opacity, 1e-12) / ALPHA_MIN)
    r = radius.to(torch.float32) / 3.0 * torch.sqrt(
        2.0 * torch.clamp_min(ratio, 0.0))
    # +1: tile_rect's far edge only guarantees pixel distance > r - 1
    r = torch.where(opacity > ALPHA_MIN, torch.ceil(r) + 1.0, 0.0)
    # the rect may clamp at the 3-sigma radius (the baseline rect)
    return torch.minimum(r, radius.to(torch.float32)).to(radius.dtype)


def _corner_cull(in_span, x0_tile, y0_tile, cull_cols,
                 tile_w: int, tile_h: int, msx: int, msy: int):
    """Drop candidate (gaussian, tile) pairs that cannot clear the
    compositing kernels' alpha >= ALPHA_MIN keep mask anywhere in the
    tile: minimize q(d) = 0.5*(ca dx^2 + cc dy^2) + cb dx dy over the
    tile's pixel-center box (padded 0.5 px) and cull when
    op * exp(-q_min) < ALPHA_MIN, with a relative slack on the threshold
    so float rounding cannot drop a contributing pair. Shapes: in_span
    [S, P] (S = msy*msx span slots), x0_tile/y0_tile [P], cull_cols [P, 6]
    = (x, y, ca, cb, cc, thr) with thr = ln(op / ALPHA_MIN)."""
    cs = cull_cols
    px, py = cs[:, 0], cs[:, 1]
    ca, cb, cc, thr = cs[:, 2], cs[:, 3], cs[:, 4], cs[:, 5]
    dev = cs.device
    oyy, oxx = torch.meshgrid(torch.arange(msy, dtype=torch.float32, device=dev),
                              torch.arange(msx, dtype=torch.float32, device=dev),
                              indexing="ij")
    off_x = oxx.reshape(-1, 1) * tile_w               # [S, 1]
    off_y = oyy.reshape(-1, 1) * tile_h
    gx = x0_tile.to(torch.float32) * tile_w - px - 0.5   # [P]
    gy = y0_tile.to(torch.float32) * tile_h - py - 0.5
    x0 = gx[None, :] + off_x                          # [S, P]
    x1 = x0 + (tile_w - 1) + 1.0
    y0 = gy[None, :] + off_y
    y1 = y0 + (tile_h - 1) + 1.0
    ca_, cb_, cc_ = ca[None, :], cb[None, :], cc[None, :]

    def q(dx, dy):
        return 0.5 * (ca_ * dx * dx + cc_ * dy * dy) + cb_ * dx * dy

    inv_ca = (1.0 / torch.clamp_min(ca, 1e-12))[None, :]
    inv_cc = (1.0 / torch.clamp_min(cc, 1e-12))[None, :]
    # exact min over the box: 0 if the center is inside, else the least of
    # the four edge minima (PSD quadratic)
    yx0 = torch.clamp(-cb_ * x0 * inv_cc, y0, y1)
    yx1 = torch.clamp(-cb_ * x1 * inv_cc, y0, y1)
    xy0 = torch.clamp(-cb_ * y0 * inv_ca, x0, x1)
    xy1 = torch.clamp(-cb_ * y1 * inv_ca, x0, x1)
    q_min = torch.minimum(
        torch.minimum(q(x0, yx0), q(x1, yx1)),
        torch.minimum(q(xy0, y0), q(xy1, y1)))
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    q_min = torch.where(inside, 0.0, q_min)
    keep = (q_min <= thr[None, :] * (1.0 + 1e-4) + 1e-5) & \
        (thr[None, :] > 0.0)
    return in_span & keep


def _candidate_keys(x0, y0, sx, sy, v, ntx: int, msx: int, msy: int):
    """[S, P] candidate tile ids and in-span mask (S = msy*msx span slots,
    row-major (sy, sx))."""
    dev = x0.device
    oyy, oxx = torch.meshgrid(torch.arange(msy, dtype=torch.int32, device=dev),
                              torch.arange(msx, dtype=torch.int32, device=dev),
                              indexing="ij")
    ox = oxx.reshape(-1, 1)
    oy = oyy.reshape(-1, 1)
    tx = x0[None, :] + ox
    ty = y0[None, :] + oy
    in_span = (ox < sx[None, :]) & (oy < sy[None, :]) & v[None, :]
    return ty * ntx + tx, in_span


def _cull_cols(pre: Preprocessed, opacity: torch.Tensor) -> torch.Tensor:
    """[P, 6] columns (x, y, ca, cb, cc, ln(op / ALPHA_MIN)) for
    _corner_cull."""
    thr = torch.log(torch.clamp_min(opacity, 1e-12) / ALPHA_MIN)
    return torch.stack(
        [pre.mean2d[:, 0], pre.mean2d[:, 1], pre.conic[:, 0],
         pre.conic[:, 1], pre.conic[:, 2], thr], dim=1)


class BucketedBinning(NamedTuple):
    """Rank-block bucketed binning: gaussians are depth-sorted, the rank
    axis is split into B contiguous blocks, and each block's (tile, rank)
    pairs are sorted on their own. Blocks partition the depth order, so a
    tile's buckets 0..B-1 taken in order are its pairs front to back."""
    order: torch.Tensor         # [P] gaussian ids in ascending depth
    pair_gid: torch.Tensor      # [B * cap_b] gaussian ids, bucket-major
    tile_start: torch.Tensor    # [ntiles, B] starts into the flat pair axis
    tile_count: torch.Tensor    # [ntiles, B]
    num_rendered: torch.Tensor  # [] total valid pairs (before the caps)
    overflow: torch.Tensor      # [] pairs lost to the per-bucket caps
    span_overflow: torch.Tensor  # [] pairs lost to the static tile-span cap


class Binning(NamedTuple):
    order: torch.Tensor         # [P] gaussian ids in ascending depth
    pair_gid: torch.Tensor      # [NPAIR] gaussian id per sorted pair (P = none)
    tile_start: torch.Tensor    # [ntiles] range start into pair arrays
    tile_count: torch.Tensor    # [ntiles] pairs per tile
    num_rendered: torch.Tensor  # [] total valid pairs
    span_overflow: torch.Tensor  # [] pairs lost to the static tile-span cap


def _tile_grid(width: int, height: int, cfg: RasterizeConfig):
    ntx = -(-width // cfg.tile_w)
    nty = -(-height // cfg.tile_h)
    return ntx, nty


@torch.no_grad()
def pair_keys(pre: Preprocessed, width: int, height: int,
              cfg: RasterizeConfig, opacity: torch.Tensor | None = None):
    """Steps 1-2 of the binning: (order, key, num_rendered, span_overflow)
    with `order` the [P] depth order and `key` the unsorted [S*P] int32
    pair keys, tile * P + depth rank, ntiles * P where a span slot emits
    nothing. `key` is the [S, P] candidate buffer flattened; its columns
    are the gaussians in depth order (column j has rank j), so the
    bucketed layout cuts the columns into rank blocks."""
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    ntx, nty = _tile_grid(width, height, cfg)
    ntiles = ntx * nty
    if ntiles * (P + 1) >= 2 ** 31:
        raise ValueError(
            f"packed binning key overflow: ntiles={ntiles} P={P}; "
            "reduce capacity or enlarge tiles")

    if cfg.cuda_sort:
        from legslam_torch.ops.cuda.sort import argsort_f32
        order = argsort_f32(pre.depth, pre.mask)[:P]
    else:
        depth_key = torch.where(pre.mask, pre.depth, float("inf"))
        order = torch.argsort(depth_key, stable=True).to(torch.int32)

    r_bin = pre.radius if opacity is None else \
        effective_radius(pre.radius, opacity)
    rect = tile_rect(pre.mean2d, r_bin, cfg.tile_w, cfg.tile_h, ntx, nty)
    span_x = rect.x1 - rect.x0
    span_y = rect.y1 - rect.y0
    valid = pre.mask & (span_x * span_y > 0)

    msx, msy = cfg.max_span_x, cfg.max_span_y
    sentinel = ntiles * P
    cull = opacity is not None and cfg.ellipse_cull
    o = order.long()
    cols = tuple(c[o] for c in (rect.x0, rect.y0, span_x, span_y, valid))
    cull_cols = _cull_cols(pre, opacity)[o] if cull else None
    rank = torch.arange(P, dtype=torch.int32, device=dev)
    x0, y0 = cols[0], cols[1]
    tid, in_span = _candidate_keys(*cols, ntx, msx, msy)
    if cull:
        in_span = _corner_cull(in_span, x0, y0, cull_cols,
                               cfg.tile_w, cfg.tile_h, msx, msy)
    # the emitted key set encodes (tile, rank) whatever the emission
    # order, so the [S, P] buffer is sorted as it lies
    key = torch.where(in_span, tid * P + rank[None, :],
                      sentinel).reshape(-1)
    num_valid = in_span.sum(dtype=torch.int32)
    # pairs a gaussian would emit beyond the static span cap (the
    # reference never drops pairs, rasterizer_impl.cu:280-320)
    span_overflow = torch.where(
        valid, span_x * span_y
        - torch.clamp_max(span_x, msx) * torch.clamp_max(span_y, msy),
        0).sum(dtype=torch.int32)
    return order, key, num_valid, span_overflow


@torch.no_grad()
def bin_gaussians(pre: Preprocessed, width: int, height: int,
                  cfg: RasterizeConfig,
                  opacity: torch.Tensor | None = None) -> Binning:
    """Pair lists and tile ranges of the preprocessed gaussians. Passing
    the activated `opacity` enables the exact opacity-aware cull
    (effective_radius + _corner_cull, render-exact: a culled pair cannot
    clear the kernels' alpha >= 1/255 keep mask anywhere in its tile)."""
    P = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    ntx, nty = _tile_grid(width, height, cfg)
    ntiles = ntx * nty
    sentinel = ntiles * P
    order, key, num_valid, span_overflow = pair_keys(pre, width, height, cfg,
                                                     opacity)
    if cfg.cuda_sort:
        from legslam_torch.ops.cuda.sort import sort_keys
        key_sorted = sort_keys(key, key_bits=sentinel.bit_length())
    else:
        key_sorted = torch.sort(key).values
    # the kernels only read the first max_pairs sorted entries
    npair = key_sorted.shape[0]
    keep = min(cfg.max_pairs, npair) if cfg.backend == "cuda" else npair
    kk = key_sorted[:keep]
    # sentinel pairs get gid = P (out of range): the pair gather never
    # reads them for a tile, and the backward scatter-add drops them
    gid = order[(kk % P).long()]
    pair_gid = torch.where(kk < sentinel, gid, P)

    bounds = torch.arange(ntiles + 1, dtype=torch.int32, device=dev) * P
    edges = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    return Binning(order=order, pair_gid=pair_gid, tile_start=edges[:-1],
                   tile_count=edges[1:] - edges[:-1], num_rendered=num_valid,
                   span_overflow=span_overflow)


@torch.no_grad()
def trim_binning(binning: Binning, kfin: torch.Tensor, max_pairs: int,
                 chunk: int, slack_chunks: int = 1) -> Binning:
    """Termination-aware trim of a cached flat binning.

    `kfin` ([ntiles] int32) is the forward kernel's per-tile termination
    watermark (chunks processed, counted from the chunk-aligned base of
    the tile's range, before every pixel crossed T < 1e-4) from a step
    that ran with this binning. Pairs past it composited nothing and
    received no gradient then; this trims each tile's range at the
    watermark (+ `slack_chunks` of headroom) and compacts the survivors to
    a global prefix. The compaction is a step function over positions
    (src = pos + a per-segment offset), built from a scatter-add of the
    offset jumps at the new segment starts and a cumsum, so it needs no
    host synchronisation.
    """
    P = binning.order.shape[0]
    npair = binning.pair_gid.shape[0]
    dev = binning.pair_gid.device
    start = torch.clamp_max(binning.tile_start, max_pairs)
    end = torch.clamp_max(binning.tile_start + binning.tile_count, max_pairs)
    count = end - start
    base0 = torch.div(start, chunk, rounding_mode="floor") * chunk
    live_end = torch.minimum(end, base0 + (kfin + slack_chunks) * chunk)
    count_new = torch.clamp_min(live_end - start, 0).to(torch.int32)
    cum = torch.cumsum(count_new, 0)
    start_new = (cum - count_new).to(torch.int32)
    live_total = cum[-1].to(torch.int32)

    pos = torch.arange(npair, dtype=torch.int32, device=dev)
    offset = start - start_new
    jump = torch.diff(offset, prepend=offset[:1])
    jump[0] = offset[0]
    # zero-count segments share a start and add up their jumps; segments
    # starting at npair are dropped
    inside = start_new < npair
    off = torch.zeros(npair, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(inside, start_new, 0).long(),
        torch.where(inside, jump, 0).to(torch.int32))
    src = torch.clamp(pos + torch.cumsum(off, 0), 0, npair - 1)
    gid = torch.where(pos < live_total, binning.pair_gid[src.long()], P)
    return Binning(order=binning.order, pair_gid=gid.to(torch.int32),
                   tile_start=start_new, tile_count=count_new,
                   num_rendered=live_total,
                   span_overflow=binning.span_overflow)


@torch.no_grad()
def bin_gaussians_bucketed(pre: Preprocessed, width: int, height: int,
                           cfg: RasterizeConfig, n_buckets: int,
                           cap_per_bucket: int,
                           opacity: torch.Tensor | None = None
                           ) -> BucketedBinning:
    """Bucketed variant of bin_gaussians (see BucketedBinning), as
    legslam_tpu/ops/binning.py:466 builds it: the [S, P] key buffer in
    depth order is regrouped into n_buckets rows of contiguous rank blocks,
    each row sorted on its own (torch.sort along the row, the counterpart
    of JAX's batched jnp.sort), and each bucket keeps its first
    cap_per_bucket sorted pairs: valid pairs sort before the sentinels, so
    the cap only drops overflow, which is counted. P must be divisible by
    n_buckets, and cap_per_bucket a multiple of 256. A bucket whose row
    is shorter than its cap is padded with sentinels, so bucket b always
    starts at b * cap_per_bucket."""
    P = pre.mean2d.shape[0]
    if P % n_buckets:
        raise ValueError(f"capacity {P} not divisible by {n_buckets} buckets")
    if cap_per_bucket % 256:
        raise ValueError(f"bucket_cap {cap_per_bucket} not a multiple of 256")
    dev = pre.mean2d.device
    ntx, nty = _tile_grid(width, height, cfg)
    ntiles = ntx * nty
    sentinel = ntiles * P
    order, key, num_valid, span_overflow = pair_keys(
        pre, width, height, cfg, opacity)
    # bucket rows = contiguous rank blocks; the order inside a row before
    # its sort is irrelevant
    S = key.shape[0] // P
    rows = key.reshape(S, n_buckets, P // n_buckets).transpose(0, 1) \
        .reshape(n_buckets, -1)
    kept = torch.sort(rows, dim=-1).values[:, :cap_per_bucket]
    if kept.shape[1] < cap_per_bucket:
        kept = torch.nn.functional.pad(
            kept, (0, cap_per_bucket - kept.shape[1]), value=sentinel)
    kept = kept.contiguous()
    overflow = num_valid - (kept < sentinel).sum(dtype=torch.int32)
    kflat = kept.reshape(-1)
    # sentinel pairs get gid P (see bin_gaussians)
    pair_gid = torch.where(kflat < sentinel, order[(kflat % P).long()], P)
    bounds = torch.arange(ntiles + 1, dtype=torch.int32, device=dev) * P
    edges = torch.searchsorted(
        kept, bounds.expand(n_buckets, -1).contiguous(),
        side="left").to(torch.int32)                       # [B, ntiles+1]
    base = torch.arange(n_buckets, dtype=torch.int32,
                        device=dev)[:, None] * cap_per_bucket
    return BucketedBinning(
        order=order, pair_gid=pair_gid.to(torch.int32),
        tile_start=(edges[:, :-1] + base).T.contiguous(),
        tile_count=(edges[:, 1:] - edges[:, :-1]).T.contiguous(),
        num_rendered=num_valid, overflow=overflow,
        span_overflow=span_overflow)
