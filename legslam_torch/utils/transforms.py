"""Quaternion / scaling / activation helpers.

Parity references:
  - build_rotation: include/general_utils.h:29-60 (wxyz quaternion, normalized)
  - build_scaling_rotation: gaussian_model computeCov3D (forward.cu:120-153)
  - inverse_sigmoid: include/general_utils.h:25
"""
from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """Normalize [..., 4] wxyz quaternions.

    maximum-before-rsqrt, not norm().clamp(): the clamp keeps the value
    finite but the gradient still evaluates d(sqrt)/dx at 0 (= inf), and a
    zero cotangent times inf is NaN on the padded (all-zero) rows of the
    store. Values agree with the clamped norm down to |q| = 1e-12."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp_min(n2, 1e-24))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternion (normalized inside) -> [..., 3, 3] rotation
    (forward.cu:131-136 / general_utils.h:29 layout)."""
    q = normalize_quat(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def build_cov3d(scale: torch.Tensor, quat: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space 3D covariance Sigma = M M^T with M = R diag(s)
    (forward.cu:120-153), packed [..., 6] as (xx, xy, xz, yy, yz, zz)."""
    R = quat_to_rotmat(quat)
    M = R * (scale_modifier * scale)[..., None, :]
    sigma = M @ M.transpose(-1, -2)
    return torch.stack(
        [sigma[..., 0, 0], sigma[..., 0, 1], sigma[..., 0, 2],
         sigma[..., 1, 1], sigma[..., 1, 2], sigma[..., 2, 2]], -1)


def unpack_sym6(c: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed symmetric (xx, xy, xz, yy, yz, zz) -> [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = c.unbind(-1)
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)], -2)
