"""Dense per-pixel reference rasterizer: the numerical oracle.

Counterpart of legslam_tpu/ops/oracle.py. Every gaussian is composited at
every pixel (depth-sorted, with the tile membership clipping of the tiled
path), through one dense [H, W, P] weight tensor, so the tiled compositors
and the kernels can be held against it. Small scenes and images only (it
holds H * W * P floats). Semantics: cuda_rasterizer/forward.cu:261-392, as
mapped in ops/composite.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from legslam_torch.config import RasterizeConfig
from legslam_torch.ops.binning import tile_rect
from legslam_torch.ops.composite import (blend_weights, gaussian_power,
                                         masked_alpha)
from legslam_torch.ops.projection import Preprocessed


class RenderOutput(NamedTuple):
    color: torch.Tensor             # [H, W, 3]
    lang_feat: torch.Tensor | None  # [H, W, LF] or None
    depth: torch.Tensor             # [H, W]
    final_t: torch.Tensor           # [H, W] final transmittance
    radii: torch.Tensor             # [P]


def rasterize_oracle(pre: Preprocessed, rgb: torch.Tensor,
                     opacity: torch.Tensor, bg: torch.Tensor,
                     width: int, height: int, cfg: RasterizeConfig,
                     lang_feat: torch.Tensor | None = None) -> RenderOutput:
    """Rasterize with a dense [H, W, P] weight tensor.

    Args:
      pre: preprocessed gaussians (projection.preprocess output).
      rgb: [P, 3] per-gaussian colours (after SH evaluation and clamp).
      opacity: [P] activated opacities.
      bg: [3] background colour (added as C + T_final * bg; LF and depth
          get none, forward.cu:382-390).
      lang_feat: optional [P, LF] per-gaussian language features.
    """
    dev = pre.mean2d.device
    ntx = -(-width // cfg.tile_w)
    nty = -(-height // cfg.tile_h)

    depth_key = torch.where(pre.mask, pre.depth, float("inf"))
    order = torch.argsort(depth_key, stable=True)

    mean2d = pre.mean2d[order]
    conic = pre.conic[order]
    op = opacity[order]
    rect = tile_rect(mean2d, pre.radius[order], cfg.tile_w, cfg.tile_h,
                     ntx, nty)
    span_ok = (rect.x1 - rect.x0) * (rect.y1 - rect.y0) > 0
    gmask = pre.mask[order] & span_ok

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    px = xs[None, :, None]                        # [1, W, 1]
    py = ys[:, None, None]                        # [H, 1, 1]
    power = gaussian_power(mean2d[None, None], conic[None, None], px, py)

    # tile membership: the pixel's tile inside the gaussian's rect
    tx = (torch.arange(width, device=dev) // cfg.tile_w)[None, :, None]
    ty = (torch.arange(height, device=dev) // cfg.tile_h)[:, None, None]
    member = ((tx >= rect.x0[None, None]) & (tx < rect.x1[None, None]) &
              (ty >= rect.y0[None, None]) & (ty < rect.y1[None, None]))

    alpha = masked_alpha(power, op[None, None],
                         extra_mask=member & gmask[None, None])
    weights, _, t_final = blend_weights(alpha)     # [H, W, P], [H, W]

    color = torch.einsum("hwp,pc->hwc", weights, rgb[order]) \
        + t_final[..., None] * bg[None, None]
    depth = weights @ pre.depth[order].detach()
    lf = None
    if lang_feat is not None:
        lf = torch.einsum("hwp,pc->hwc", weights, lang_feat[order])
    return RenderOutput(color=color, lang_feat=lf, depth=depth,
                        final_t=t_final, radii=pre.radius)
