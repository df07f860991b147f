"""Spherical-harmonics color evaluation (degrees 0..3).

Behavioral parity with the reference SH path:
  - eval: cuda_rasterizer/forward.cu:31-71 (computeColorFromSH)
  - constants: cuda_rasterizer/auxiliary.h:21-38
  - RGB2SH/SH2RGB: include/sh_utils.h:133-139
"""
from __future__ import annotations

import torch

from legslam_torch.config import SH_C0, SH_C1, SH_C2, SH_C3


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """(rgb - 0.5) / C0  (include/sh_utils.h:133)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """sh * C0 + 0.5  (include/sh_utils.h:137)."""
    return sh * SH_C0 + 0.5


def _sh_basis(deg: int, x, y, z) -> list:
    """SH basis values b_k, each shaped like x (auxiliary.h:21-38
    constants, forward.cu:31-65 expansion order)."""
    basis = [torch.full_like(x, SH_C0)]
    if deg > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                      SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                      SH_C2[4] * (xx - yy)]
            if deg > 2:
                basis += [
                    SH_C3[0] * y * (3.0 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4.0 * zz - xx - yy),
                    SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    SH_C3[4] * x * (4.0 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3.0 * yy),
                ]
    return basis


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colors for unit directions: sh [..., K, 3] with K >= (deg+1)^2,
    dirs [..., 3]. Returns [..., 3] raw colors (before the +0.5 / clamp)."""
    basis = _sh_basis(deg, dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3])
    return sum(b * sh[..., k, :] for k, b in enumerate(basis))


def sh_to_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                campos: torch.Tensor) -> torch.Tensor:
    """Full reference color path: eval_sh(dir) + 0.5, clamped at 0
    (forward.cu:66-70; the max() zeroes gradients of clamped channels like
    the reference clamp mask, backward.cu:52-54)."""
    d = means - campos
    # guarded rsqrt, not norm().clamp(): padded rows have means == campos
    # == 0, where d(sqrt)/dx is inf and a zero cotangent times inf is NaN
    n2 = torch.sum(d * d, dim=-1, keepdim=True)
    d = d * torch.rsqrt(torch.clamp_min(n2, 1e-24))
    rgb = eval_sh(deg, sh, d) + 0.5
    return torch.clamp_min(rgb, 0.0)
