"""PAMR: Pixel-Adaptive Mask Refinement (the eval-path mask refinement).

Counterpart of legslam_tpu/models/pamr.py, the Talk2DINO eval refinement
(eval/open_vocabulary_segmentation/models/dinotext/pamr.py, used via
apply_pamr with 10 iterations and dilations [1, 2, 4, 8, 12, 24],
dinotext.py:278-289): masks are iteratively re-weighted by pixel
affinities computed from the image, a softmax over the 8 dilated
neighbours of the negative absolute intensity difference, normalised by
its population standard deviation over the neighbours.

Plain tensor code on the image's device: each neighbour is a gather with
clamped indices, the edge padding of the JAX module's `_shift`, which
holds when a dilation exceeds the image side.
"""
from __future__ import annotations

import torch

# 8-neighborhood offsets (dy, dx)
_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
            (1, 1))

DEFAULT_DILATIONS = (1, 2, 4, 8, 12, 24)
DEFAULT_ITERATIONS = 10


def _neighbor_index(h: int, w: int, dilations, device):
    """[K, H, 1] row and [K, 1, W] column indices of the stacked dilated
    8-neighbourhoods: neighbour k of (y, x) is (y - dy, x - dx), clamped
    to the image (edge padding)."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    iy, ix = [], []
    for d in dilations:
        for dy, dx in _OFFSETS:
            iy.append((ys - dy * d).clamp(0, h - 1))
            ix.append((xs - dx * d).clamp(0, w - 1))
    return torch.stack(iy)[:, :, None], torch.stack(ix)[:, None, :]


def _neighbors(x: torch.Tensor, index) -> torch.Tensor:
    """[H, W, C] -> [K, H, W, C] stacked dilated neighbourhoods."""
    iy, ix = index
    return x[iy, ix]


def pamr(image, masks, iterations: int = DEFAULT_ITERATIONS,
         dilations: tuple = DEFAULT_DILATIONS) -> torch.Tensor:
    """Refine soft masks with pixel-adaptive affinities.

    Args:
      image: [H, W, 3] float RGB (tensor or array).
      masks: [H, W, N] per-class soft masks, on the image's device.
    Returns refined [H, W, N] masks.
    """
    image = torch.as_tensor(image, dtype=torch.float32)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=image.device)
    index = _neighbor_index(image.shape[0], image.shape[1], dilations,
                            image.device)
    # affinity logits: -|I(p) - I(q)| averaged over channels, normalised by
    # the population std over the neighbours (the reference's AffinityLayer)
    diff = (_neighbors(image, index) - image[None]).abs().mean(-1)  # [K,H,W]
    mu = diff.mean(0, keepdim=True)
    std = ((diff - mu) ** 2).mean(0, keepdim=True).sqrt() + 1e-8
    aff = torch.softmax(-diff / std, dim=0)[..., None]              # [K,H,W,1]
    for _ in range(iterations):
        masks = (aff * _neighbors(masks, index)).sum(0)
    return masks
