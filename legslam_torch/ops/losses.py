"""Loss library: L1, PSNR, SSIM, language-feature cosine.

Behavioral parity with include/loss_utils.h:
  - l1_loss:                    loss_utils.h:27
  - psnr (10*log10(1/mse)):     loss_utils.h:31
  - cosine_similarity over the 64-D channel axis per pixel, mean over
    pixels (loss_utils.h:36-40). The training loss ADDS the mean cosine
    similarity (gaussian_mapper.cpp:716-721); the sign is replicated.
  - ssim: 11x11 Gaussian window sigma=1.5, per-channel, zero padding,
    C1=0.01^2, C2=0.03^2 (loss_utils.h:52-131).

Images are channel-last [H, W, C] float32 in [0, 1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from legslam_torch.config import SSIM_C1, SSIM_C2, SSIM_SIGMA, SSIM_WINDOW


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """L1 with only the rendered side masked, against the unmasked GT
    (gaussian_mapper.cpp:711-721): masked-out pixels still count |0 - gt|."""
    return torch.mean(torch.abs(pred * mask - gt))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def psnr_gaussian_splatting(img1: torch.Tensor, img2: torch.Tensor
                            ) -> torch.Tensor:
    """Per-channel MSE, then 20*log10(1/sqrt(mse)), averaged over the
    channels (loss_utils.h:46). Channel-last input; the reference views
    [C, -1]."""
    mse = torch.mean((img1 - img2) ** 2, dim=(0, 1))
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def _lf_cos_masked(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Mean over pixels of cosine(mask * pred, gt) along the channel axis,
    with the rendered-side mask folded into the channel reductions
    (dot *= m, |pred|^2 *= m^2), so the masked [H, W, 64] render is never
    materialized. Denominators are sqrt(max(|v|^2, eps^2)), torch's
    cosine_similarity clamp; the max() also keeps the gradient finite at
    the zero vector (rendered LF is exactly zero at init)."""
    dot = torch.sum(pred * gt, dim=-1)
    nsq1 = torch.sum(pred * pred, dim=-1)
    if mask is not None:
        dot = dot * mask
        nsq1 = nsq1 * (mask * mask)
    nsq2 = torch.sum(gt * gt, dim=-1)
    n1 = torch.sqrt(torch.clamp_min(nsq1, eps * eps))
    n2 = torch.sqrt(torch.clamp_min(nsq2, eps * eps))
    return torch.mean(dot / (n1 * n2))


def lf_cosine_similarity(pred: torch.Tensor, gt: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    return _lf_cos_masked(pred, gt, None, eps)


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """[n, n] banded blur operator: (M @ x)[i] = sum_k win[k] x[i+k-half],
    rows truncated at the borders (== zero padding)."""
    win = _gaussian_window(window_size, sigma)
    half = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k in range(window_size):
        d = k - half
        idx = np.arange(max(0, -d), min(n, n - d))
        m[idx, idx + d] = win[k]
    return m


@functools.lru_cache(maxsize=16)
def _band_tensor(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """_band_matrix on `device`, copied there once: a copy from pageable
    host memory per step would also stall the host until the device
    drained its queue."""
    return torch.as_tensor(_band_matrix(n, window_size, sigma),
                           device=device)


def _blur(img: torch.Tensor, window_size: int = SSIM_WINDOW,
          sigma: float = SSIM_SIGMA) -> torch.Tensor:
    """Separable 11x11 blur with zero padding, per channel ([H, W, C]), as
    two banded float32 matrix products over the blurred axis (TF32 is off
    for the package, see legslam_torch/__init__.py)."""
    h, w, c = img.shape
    mh = _band_tensor(h, window_size, sigma, img.device)
    mw = _band_tensor(w, window_size, sigma, img.device)
    x = (mh @ img.reshape(h, w * c)).reshape(h, w, c)
    y = (mw @ x.permute(1, 0, 2).reshape(w, h * c)).reshape(w, h, c)
    return y.permute(1, 0, 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = SSIM_WINDOW, sigma: float = SSIM_SIGMA
         ) -> torch.Tensor:
    """Mean SSIM map (loss_utils.h:76-116, zero-padded conv); the five
    blurred statistics share one pair of banded products."""
    c = img1.shape[-1]
    stack = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    b = _blur(stack, window_size, sigma)
    mu1, mu2 = b[..., :c], b[..., c:2 * c]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = b[..., 2 * c:3 * c] - mu1_sq
    sigma2_sq = b[..., 3 * c:4 * c] - mu2_sq
    sigma12 = b[..., 4 * c:] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + SSIM_C1) * (2 * sigma12 + SSIM_C2)) / \
        ((mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2))
    return torch.mean(ssim_map)


def mapping_loss(render_color: torch.Tensor, gt_color: torch.Tensor,
                 render_lf: torch.Tensor | None, gt_lf: torch.Tensor | None,
                 render_depth: torch.Tensor, gt_depth: torch.Tensor,
                 mask: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """The training loss (gaussian_mapper.cpp:711-721):

      (1-λ)*L1(img) + λ*(1-SSIM(img)) + mean_cos(LF) + L1(depth)

    The undistortion mask multiplies only the rendered tensors; the +cos
    sign is intentional (see the module docstring).
    """
    m = mask[..., None] if mask.ndim == 2 else mask
    pc = render_color * m
    loss = (1.0 - lambda_dssim) * l1_loss(pc, gt_color) + \
        lambda_dssim * (1.0 - ssim(pc, gt_color))
    if render_lf is not None and gt_lf is not None:
        loss = loss + _lf_cos_masked(render_lf, gt_lf, m[..., 0], 1e-8)
    md = mask if mask.ndim == 2 else mask[..., 0]
    return loss + l1_loss(render_depth * md, gt_depth)
