"""Front-to-back alpha compositing as cumprod + matmul (reference compositor).

The reference composites sequentially per pixel
(cuda_rasterizer/forward.cu:261-392). Front-to-back blending is an
associative recurrence, so here every alpha of a chunk is computed at once,
an exclusive cumulative product of (1 - alpha) gives the transmittances,
and the channel reduction is one matmul. Its autograd gradient is the
reference's gradient contract (backward.cu:399-612) given:

  * a straight-through gradient on the alpha <= 0.99 clamp
    (backward.cu:591-597),
  * hard (non-differentiated) masks for the power > 0 / alpha < 1/255
    skips and the T < 1e-4 termination (forward.cu:340-357),
  * the per-gaussian view depth treated as a constant
    (backward.cu:573-580).
"""
from __future__ import annotations

from typing import Tuple

import torch

from legslam_torch.config import ALPHA_MAX, ALPHA_MIN, T_TERMINATE


def gaussian_power(mean2d: torch.Tensor, conic: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Exponent of the 2D gaussian at pixel centers:
    -0.5*(a dx^2 + c dy^2) - b dx dy (forward.cu:338-341)."""
    dx = mean2d[..., 0] - px
    dy = mean2d[..., 1] - py
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def masked_alpha(power: torch.Tensor, opacity: torch.Tensor,
                 extra_mask: torch.Tensor | None = None) -> torch.Tensor:
    """alpha = min(0.99, opacity * exp(power)), zero where power > 0 or
    alpha < 1/255 (forward.cu:340-346); the clamp is straight-through."""
    g = torch.exp(torch.clamp_max(power, 0.0))
    raw = opacity * g
    alpha = raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()
    keep = (power <= 0.0) & (alpha.detach() >= ALPHA_MIN)
    if extra_mask is not None:
        keep = keep & extra_mask
    return torch.where(keep, alpha, 0.0)


def blend_weights(alpha: torch.Tensor,
                  t_all_in: torch.Tensor | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-contribution blend weights along the last (depth-ordered) axis.

    Returns (weights, t_all_out, t_fin_delta):
      * weights[..., k] = alpha_k * T_k * contrib_k, with T_k the exclusive
        product of (1 - alpha) times the incoming transmittance and
        contrib_k the rule "composite iff T_k * (1 - alpha_k) >= 1e-4"
        (forward.cu:347-357);
      * t_all_out: the all-alpha transmittance carry (monotone, so a
        terminated pixel stays terminated across later chunks);
      * t_fin_delta: this block's product over composited gaussians only,
        the factor of the final T (background term).
    """
    one_minus = 1.0 - alpha
    inclusive = torch.cumprod(one_minus, dim=-1)
    if t_all_in is not None:
        inclusive = inclusive * t_all_in[..., None]
    exclusive = inclusive / torch.where(one_minus > 0, one_minus, 1.0)
    contrib = inclusive.detach() >= T_TERMINATE
    weights = torch.where(contrib, alpha * exclusive, 0.0)
    t_all_out = (t_all_in if t_all_in is not None else 1.0) * \
        torch.prod(one_minus, dim=-1)
    t_steps = torch.where(contrib, one_minus, 1.0)
    t_fin_delta = torch.prod(t_steps, dim=-1)
    return weights, t_all_out, t_fin_delta
