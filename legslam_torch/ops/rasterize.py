"""Tiled differentiable rasterizer: the render path of the mapping step.

Counterpart of legslam_tpu/ops/rasterize.py (reference
GaussianRenderer::render, src/gaussian_renderer.cpp:23-161 and
Rasterizer::forward, rasterizer_impl.cu:198-343):

  * the per-gaussian prologue (projection, EWA conic and radius, SH colour
    and the fused feature matrix) over the capacity-padded gaussian axis,
    one kernel launch each way (ops/cuda/prologue.py; on CPU tensors its
    plain version: ops/projection.py, utils/sh.py),
  * packed-key sort binning (ops/binning.py),
  * compositing of RGB(3) + language features(64) + view depth(1) as one
    fused feature matrix, by one of two backends:
      - "torch": the reference compositor, per-tile chunks of cumprod
        blend weights and a matmul channel reduction, differentiated by
        autograd (ops/composite.py);
      - "cuda": the hand-written forward and backward compositing kernels
        (ops/cuda/), which run their plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from legslam_torch.config import RasterizeConfig
from legslam_torch.ops.binning import (Binning, bin_gaussians,
                                       bin_gaussians_bucketed)
from legslam_torch.ops.composite import blend_weights, masked_alpha
from legslam_torch.ops.cuda.prologue import View, prologue
from legslam_torch.ops.projection import Preprocessed
from legslam_torch.ops.slabs import prefix_rows, watermark
from legslam_torch.utils import runtime
from legslam_torch.utils.camera import CameraView


def _prologue_rows(cfg: RasterizeConfig, valid: torch.Tensor,
                   watermark_hint: int | None) -> int:
    """The rows the prologue computes: with cfg.p_slabs (and a capacity it
    divides) the whole-slab prefix covering the live watermark
    (ops/slabs.py), else all of them."""
    P = valid.shape[0]
    if not cfg.p_slabs or P % cfg.p_slabs:
        return P
    hi = watermark(valid) if watermark_hint is None else watermark_hint
    return prefix_rows(hi, P, cfg.p_slabs)


class RasterizeOutput(NamedTuple):
    color: torch.Tensor             # [H, W, 3]
    lang_feat: torch.Tensor | None  # [H, W, LF]
    depth: torch.Tensor             # [H, W]
    final_t: torch.Tensor           # [H, W]
    radii: torch.Tensor             # [P] int32
    num_rendered: torch.Tensor      # [] int32 valid pairs
    # pairs dropped by a static cap (span clip, max_pairs, max_per_tile);
    # the reference never drops pairs, so nonzero means lost coverage
    overflow_pairs: torch.Tensor    # [] int32
    # per-tile termination watermark ("cuda" backend with emit_kfin only);
    # feeds binning.trim_binning
    kfin: torch.Tensor | None = None  # [ntiles] int32


def _composite_tiles(binning: Binning, mean2d: torch.Tensor,
                     conic: torch.Tensor, opacity: torch.Tensor,
                     feats: torch.Tensor, width: int, height: int,
                     cfg: RasterizeConfig, max_per_tile: int):
    """The "torch" compositor: returns ([H, W, C], final_t [H, W])."""
    P = mean2d.shape[0]
    C = feats.shape[-1]
    TW, TH = cfg.tile_w, cfg.tile_h
    ntx = -(-width // TW)
    nty = -(-height // TH)
    ntiles = ntx * nty
    npix = TH * TW
    chunk = cfg.chunk
    npair = binning.pair_gid.shape[0]
    dev = mean2d.device
    xs = torch.arange(TW, dtype=torch.float32, device=dev)
    ys = torch.arange(TH, dtype=torch.float32, device=dev)
    koff = torch.arange(chunk, device=dev)

    tiles, t_fins = [], []
    for t0 in range(0, ntiles, cfg.tile_batch):
        tile_ids = torch.arange(t0, min(t0 + cfg.tile_batch, ntiles),
                                device=dev)
        B = tile_ids.shape[0]
        start = binning.tile_start[tile_ids].long()
        count = torch.clamp_max(binning.tile_count[tile_ids], max_per_tile)
        px = (tile_ids % ntx).float()[:, None] * TW + xs[None, :]   # [B, TW]
        py = (tile_ids // ntx).float()[:, None] * TH + ys[None, :]  # [B, TH]
        t_all = torch.ones(B, npix, device=dev)
        t_fin = torch.ones(B, npix, device=dev)
        acc = torch.zeros(B, npix, C, device=dev)
        # chunks past every tile's count composite nothing
        for k in range(-(-int(count.max()) // chunk)):
            pos = k * chunk + koff[None, :]                     # [B, chunk]
            pvalid = pos < count[:, None]
            idx = torch.clamp(start[:, None] + pos, 0, npair - 1)
            # sentinel ids (P) only sit outside tile ranges (pvalid False)
            gid = torch.clamp_max(binning.pair_gid[idx].long(), P - 1)
            m2, con, op, f = mean2d[gid], conic[gid], opacity[gid], feats[gid]
            dx = m2[..., 0][:, None, None, :] - px[:, None, :, None]
            dy = m2[..., 1][:, None, None, :] - py[:, :, None, None]
            a = con[..., 0][:, None, None, :]
            b = con[..., 1][:, None, None, :]
            c = con[..., 2][:, None, None, :]
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = masked_alpha(power, op[:, None, None, :],
                                 extra_mask=pvalid[:, None, None, :])
            w, t_all, t_fin_delta = blend_weights(
                alpha.reshape(B, npix, chunk), t_all)
            acc = acc + torch.bmm(w, f)
            t_fin = t_fin * t_fin_delta
        tiles.append(acc)
        t_fins.append(t_fin)

    img = torch.cat(tiles).reshape(nty, ntx, TH, TW, C).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * TH, ntx * TW, C)[:height, :width]
    tf = torch.cat(t_fins).reshape(nty, ntx, TH, TW).permute(0, 2, 1, 3)
    tf = tf.reshape(nty * TH, ntx * TW)[:height, :width]
    return img, tf


def _apply_crop(pre: Preprocessed, crop_y, crop_h: int | None,
                height: int):
    """Shift the screen-space means to a pixel-row strip's frame and
    return the strip height (legslam_tpu/ops/rasterize.py:157-166). One
    definition for the cached strip binning (compute_binning) and the
    fresh one in the render (render_arrays), so both shift alike."""
    if crop_y is None:
        return pre, height
    shift = torch.zeros(2, device=pre.mean2d.device)
    shift[1] = torch.as_tensor(crop_y, dtype=torch.float32)
    return pre._replace(mean2d=pre.mean2d - shift[None, :]), crop_h


def make_binning(pre: Preprocessed, width: int, height: int,
                 cfg: RasterizeConfig, max_per_tile: int,
                 opacity: torch.Tensor | None = None):
    """Bin preprocessed gaussians; returns (binning, overflow_pairs). It
    depends only on geometry and carries no gradient, so callers may cache
    it across iterations of one view. Passing `opacity` (activated, [P])
    enables the exact opacity-aware pair cull. On the "cuda" backend with
    cfg.n_buckets > 1 the binning is a BucketedBinning, whose overflow
    counts the pairs past each bucket's cap."""
    if cfg.backend == "cuda" and cfg.n_buckets > 1:
        binning = bin_gaussians_bucketed(pre, width, height, cfg,
                                         cfg.n_buckets, cfg.bucket_cap,
                                         opacity=opacity)
        overflow = binning.span_overflow + binning.overflow
    elif cfg.backend == "cuda":
        binning = bin_gaussians(pre, width, height, cfg, opacity=opacity)
        overflow = binning.span_overflow + torch.clamp_min(
            binning.num_rendered - cfg.max_pairs, 0)
    else:
        binning = bin_gaussians(pre, width, height, cfg, opacity=opacity)
        overflow = binning.span_overflow + torch.clamp_min(
            binning.tile_count - max_per_tile, 0).sum()
    return binning, overflow.to(torch.int32)


@torch.no_grad()
def compute_binning(means3d: torch.Tensor, scales: torch.Tensor,
                    quats: torch.Tensor, valid: torch.Tensor,
                    world_view: torch.Tensor, full_proj: torch.Tensor,
                    tan_fovx, tan_fovy, width: int, height: int,
                    cfg: RasterizeConfig, max_per_tile: int = 2048,
                    scale_modifier: float = 1.0,
                    opacity: torch.Tensor | None = None,
                    crop_y=None, crop_h: int | None = None,
                    watermark_hint: int | None = None):
    """Standalone binning for callers that cache it (activated scales and
    opacity expected, like render_arrays). crop_y/crop_h bin only the
    pixel-row strip [crop_y, crop_y + crop_h) (see render_arrays);
    watermark_hint as in render_arrays."""
    view = View(world_view, full_proj, None, width, height,
                width / (2.0 * tan_fovx), height / (2.0 * tan_fovy),
                tan_fovx, tan_fovy, scale_modifier)
    pre, _ = prologue(means3d, scales, quats, valid, view,
                      _prologue_rows(cfg, valid, watermark_hint))
    pre, height = _apply_crop(pre, crop_y, crop_h, height)
    return make_binning(pre, width, height, cfg, max_per_tile,
                        opacity=opacity)


def render_arrays(means3d: torch.Tensor, sh: torch.Tensor,
                  lang_feat: torch.Tensor, opacity: torch.Tensor,
                  scales: torch.Tensor, quats: torch.Tensor,
                  valid: torch.Tensor, world_view: torch.Tensor,
                  full_proj: torch.Tensor, cam_center: torch.Tensor,
                  tan_fovx, tan_fovy, width: int, height: int,
                  bg: torch.Tensor, active_sh_degree: int,
                  cfg: RasterizeConfig,
                  include_lang_feat: bool = True,
                  scale_modifier: float = 1.0,
                  mean2d_offset: torch.Tensor | None = None,
                  max_per_tile: int = 2048,
                  colors_precomp: torch.Tensor | None = None,
                  stop_depth_grad: bool = True,
                  binning=None,
                  crop_y=None, crop_h: int | None = None,
                  emit_kfin: bool = False,
                  watermark_hint: int | None = None) -> RasterizeOutput:
    """Core render on raw tensors. See `rasterize` for argument docs.
    `binning` is an optional cached (Binning, overflow) pair from
    compute_binning; it must be dropped on any store surgery.

    crop_y/crop_h render only the pixel-row strip [crop_y, crop_y +
    crop_h) of the full image: projection, the EWA clamp and the focal
    lengths stay those of the full image, and only binning and
    compositing shrink to the strip (crop_h a multiple of tile_h). The
    outputs are [crop_h, W]. A strip equals the matching rows of the full
    render whenever the full render has span_overflow 0 (a strip clamps a
    gaussian's tile rect at its edge, so the span cap truncates less).

    The per-gaussian prologue (preprocess, SH, the feature matrix;
    ops/cuda/prologue.py: its kernel pair for CUDA tensors whatever the
    compositor, its plain version for CPU tensors) runs, with cfg.p_slabs,
    on the whole-slab prefix of the rows that covers the store's live
    watermark (ops/slabs.py), the rest inert. `watermark_hint` is that
    watermark when the caller knows it on the host; None reads it from
    `valid` (one synchronisation). stop_depth_grad: the reference
    accumulates dL/ddepth per gaussian but never applies it to the means
    (backward.cu:573-580 vs preprocess); True replicates that dead end."""
    view = View(world_view, full_proj, cam_center, width, height,
                width / (2.0 * tan_fovx), height / (2.0 * tan_fovy),
                tan_fovx, tan_fovy, scale_modifier)
    with runtime.span("render.prologue"):
        pre, feats = prologue(
            means3d, scales, quats, valid, view,
            _prologue_rows(cfg, valid, watermark_hint),
            sh=sh if colors_precomp is None else None, colors=colors_precomp,
            lang_feat=lang_feat if include_lang_feat else None,
            offset=mean2d_offset, active_sh_degree=active_sh_degree,
            stop_depth_grad=stop_depth_grad)
    pre, height = _apply_crop(pre, crop_y, crop_h, height)

    if binning is None:
        binning, overflow = make_binning(pre, width, height, cfg,
                                         max_per_tile, opacity=opacity)
    else:
        binning, overflow = binning
    kfin = None
    if cfg.backend == "cuda":
        from legslam_torch.ops.cuda.composite import composite_image
        img, t_final, kfin_all = composite_image(
            binning, pre.mean2d, pre.conic, opacity, feats, width, height,
            cfg.tile_w, cfg.tile_h, cfg.max_pairs, cfg.chunk, cfg.mm_dtype,
            cfg.n_buckets)
        if emit_kfin:
            kfin = kfin_all
    else:
        with runtime.span("render.composite"):
            img, t_final = _composite_tiles(
                binning, pre.mean2d, pre.conic, opacity, feats,
                width, height, cfg, max_per_tile)

    color = img[..., :3] + t_final[..., None] * bg[None, None]
    lf = img[..., 3:-1] if include_lang_feat else None
    return RasterizeOutput(color=color, lang_feat=lf, depth=img[..., -1],
                           final_t=t_final, radii=pre.radius,
                           num_rendered=binning.num_rendered,
                           overflow_pairs=overflow, kfin=kfin)


def rasterize(means3d: torch.Tensor, sh: torch.Tensor,
              lang_feat: torch.Tensor, opacity: torch.Tensor,
              scales: torch.Tensor, quats: torch.Tensor,
              valid: torch.Tensor, view: CameraView, bg: torch.Tensor,
              active_sh_degree: int, cfg: RasterizeConfig | None = None,
              include_lang_feat: bool = True, scale_modifier: float = 1.0,
              mean2d_offset: torch.Tensor | None = None,
              max_per_tile: int = 2048,
              colors_precomp: torch.Tensor | None = None,
              stop_depth_grad: bool = True) -> RasterizeOutput:
    """Render activated gaussian parameters from a camera view.

    Args:
      means3d: [P, 3] world positions.
      sh: [P, K, 3] SH coefficients (DC first; K >= (deg+1)^2).
      lang_feat: [P, LF] language features.
      opacity: [P] activated (sigmoid) opacities.
      scales: [P, 3] activated (exp) scales.
      quats: [P, 4] wxyz rotations (normalized inside).
      valid: [P] bool mask of live gaussians in the padded store.
      mean2d_offset: optional [P, 2] zeros; its gradient is the
        pixel-space mean2D gradient of the densification statistics (the
        reference's screenspace_points, gaussian_renderer.cpp:41-48).
    All tensors lie on one device, the view's.
    """
    cfg = cfg or RasterizeConfig()
    return render_arrays(
        means3d, sh, lang_feat, opacity, scales, quats, valid,
        view.world_view, view.full_proj, view.cam_center,
        view.tan_fovx, view.tan_fovy, view.width, view.height, bg,
        active_sh_degree, cfg, include_lang_feat, scale_modifier,
        mean2d_offset, max_per_tile, colors_precomp, stop_depth_grad)
