"""Tiled differentiable rasterizer: the render path of the mapping step.

Counterpart of legslam_tpu/ops/rasterize.py (reference
GaussianRenderer::render, src/gaussian_renderer.cpp:23-161 and
Rasterizer::forward, rasterizer_impl.cu:198-343):

  * preprocess over the capacity-padded gaussian axis (ops/projection.py),
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
from legslam_torch.ops.binning import Binning, bin_gaussians
from legslam_torch.ops.composite import blend_weights, masked_alpha
from legslam_torch.ops.projection import Preprocessed, preprocess
from legslam_torch.utils.camera import CameraView
from legslam_torch.utils.sh import sh_to_color
from legslam_torch.utils.transforms import normalize_quat


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


def make_binning(pre: Preprocessed, width: int, height: int,
                 cfg: RasterizeConfig, max_per_tile: int,
                 opacity: torch.Tensor | None = None):
    """Bin preprocessed gaussians; returns (binning, overflow_pairs). It
    depends only on geometry and carries no gradient, so callers may cache
    it across iterations of one view. Passing `opacity` (activated, [P])
    enables the exact opacity-aware pair cull."""
    binning = bin_gaussians(pre, width, height, cfg, opacity=opacity)
    if cfg.backend == "cuda":
        overflow = binning.span_overflow + torch.clamp_min(
            binning.num_rendered - cfg.max_pairs, 0)
    else:
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
                    opacity: torch.Tensor | None = None):
    """Standalone binning for callers that cache it (activated scales and
    opacity expected, like render_arrays)."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    pre = preprocess(means3d, scales, normalize_quat(quats), valid,
                     world_view, full_proj, width, height, focal_x, focal_y,
                     tan_fovx, tan_fovy, scale_modifier)
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
                  emit_kfin: bool = False) -> RasterizeOutput:
    """Core render on raw tensors. See `rasterize` for argument docs.
    `binning` is an optional cached (Binning, overflow) pair from
    compute_binning; it must be dropped on any store surgery."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    pre = preprocess(means3d, scales, normalize_quat(quats), valid,
                     world_view, full_proj, width, height, focal_x, focal_y,
                     tan_fovx, tan_fovy, scale_modifier)
    if mean2d_offset is not None:
        pre = pre._replace(mean2d=pre.mean2d + mean2d_offset)
    rgb = colors_precomp if colors_precomp is not None else \
        sh_to_color(active_sh_degree, sh, means3d, cam_center)
    # the reference accumulates dL/ddepth per gaussian but never applies it
    # to the means (backward.cu:573-580 vs preprocess); stop_depth_grad
    # replicates that dead end
    depth = pre.depth.detach() if stop_depth_grad else pre.depth
    parts = [rgb] + ([lang_feat] if include_lang_feat else []) + \
        [depth[:, None]]
    feats = torch.cat(parts, dim=-1)

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
            cfg.tile_w, cfg.tile_h, cfg.max_pairs, cfg.chunk, cfg.mm_dtype)
        if emit_kfin:
            kfin = kfin_all
    else:
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
