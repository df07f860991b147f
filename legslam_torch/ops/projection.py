"""Per-Gaussian preprocessing: projection, EWA cov2D, conic, screen radius.

Behavioral parity with cuda_rasterizer/forward.cu:
  - in_frustum near-cull at z<=0.2:            auxiliary.h:139-160
  - projection with w-guard 1e-7:              forward.cu:197-199
  - computeCov2D (EWA + viewspace clamp 1.3):  forward.cu:74-112
  - conic + eigenvalue radius ceil(3*sqrt):    forward.cu:226-232
  - ndc2Pix:                                   auxiliary.h:41-44

Batched over the capacity-padded gaussian axis as [P] columns; culled
gaussians are reported through the returned mask (radius 0), as the
reference's early returns do (forward.cu:186-244).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from legslam_torch.config import (
    COV2D_LOWPASS,
    NEAR_CLIP,
    PROJ_W_EPS,
    RADIUS_EIG_GUARD,
    VIEW_CLAMP,
)
from legslam_torch.utils.camera import ndc2pix


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor     # [P, 2] pixel coordinates
    conic: torch.Tensor      # [P, 3] inverse cov2d (a, b, c)
    depth: torch.Tensor      # [P] view-space z
    radius: torch.Tensor     # [P] int32 screen radius (0 = culled)
    mask: torch.Tensor       # [P] bool: visible & valid


def project_points(means3d: torch.Tensor, full_proj: torch.Tensor,
                   width: int, height: int):
    """Project world points to pixel coords. Returns (pix[P,2], ndc_z[P], w)."""
    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    fp = full_proj
    hx = fp[0, 0] * x + fp[0, 1] * y + fp[0, 2] * z + fp[0, 3]
    hy = fp[1, 0] * x + fp[1, 1] * y + fp[1, 2] * z + fp[1, 3]
    hz = fp[2, 0] * x + fp[2, 1] * y + fp[2, 2] * z + fp[2, 3]
    hw = fp[3, 0] * x + fp[3, 1] * y + fp[3, 2] * z + fp[3, 3]
    p_w = 1.0 / (hw + PROJ_W_EPS)
    pix = torch.stack([ndc2pix(hx * p_w, width), ndc2pix(hy * p_w, height)],
                      -1)
    return pix, hz * p_w, p_w


def _cov3d_cols(scales: torch.Tensor, quats: torch.Tensor,
                scale_modifier: float):
    """Sigma = (R diag(s)) (R diag(s))^T (forward.cu:120-153) as 6 [P]
    columns (xx, xy, xz, yy, yz, zz); quats [P,4] wxyz."""
    w, qx, qy, qz = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    # guarded rsqrt (see utils/transforms.normalize_quat)
    inv_n = torch.rsqrt(
        torch.clamp_min(w * w + qx * qx + qy * qy + qz * qz, 1e-24))
    w, qx, qy, qz = w * inv_n, qx * inv_n, qy * inv_n, qz * inv_n
    sx = scales[:, 0] * scale_modifier
    sy = scales[:, 1] * scale_modifier
    sz = scales[:, 2] * scale_modifier
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - w * qz)
    r02 = 2 * (qx * qz + w * qy)
    r10 = 2 * (qx * qy + w * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - w * qx)
    r20 = 2 * (qx * qz - w * qy)
    r21 = 2 * (qy * qz + w * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    xx = m00 * m00 + m01 * m01 + m02 * m02
    xy = m00 * m10 + m01 * m11 + m02 * m12
    xz = m00 * m20 + m01 * m21 + m02 * m22
    yy = m10 * m10 + m11 * m11 + m12 * m12
    yz = m10 * m20 + m11 * m21 + m12 * m22
    zz = m20 * m20 + m21 * m21 + m22 * m22
    return xx, xy, xz, yy, yz, zz


def _cov2d_cols(x, y, z, cov6, world_view, focal_x, focal_y,
                tan_fovx, tan_fovy, in_front):
    """EWA cov2d (forward.cu:74-112) as (c00, c01, c11) [P] columns with
    the +0.3 low-pass applied. `in_front` guards the divisions by a
    non-positive view z of culled points (values and gradients stay
    finite; those lanes are masked downstream)."""
    wv = world_view
    tx = wv[0, 0] * x + wv[0, 1] * y + wv[0, 2] * z + wv[0, 3]
    ty = wv[1, 0] * x + wv[1, 1] * y + wv[1, 2] * z + wv[1, 3]
    tz = wv[2, 0] * x + wv[2, 1] * y + wv[2, 2] * z + wv[2, 3]
    tz = torch.where(in_front, tz, 1.0)
    limx = VIEW_CLAMP * tan_fovx
    limy = VIEW_CLAMP * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    # T = J @ Rw2c
    t00 = j00 * wv[0, 0] + j02 * wv[2, 0]
    t01 = j00 * wv[0, 1] + j02 * wv[2, 1]
    t02 = j00 * wv[0, 2] + j02 * wv[2, 2]
    t10 = j11 * wv[1, 0] + j12 * wv[2, 0]
    t11 = j11 * wv[1, 1] + j12 * wv[2, 1]
    t12 = j11 * wv[1, 2] + j12 * wv[2, 2]

    xx, xy, xz, yy, yz, zz = cov6
    v0a = xx * t00 + xy * t01 + xz * t02
    v1a = xy * t00 + yy * t01 + yz * t02
    v2a = xz * t00 + yz * t01 + zz * t02
    v0b = xx * t10 + xy * t11 + xz * t12
    v1b = xy * t10 + yy * t11 + yz * t12
    v2b = xz * t10 + yz * t11 + zz * t12
    c00 = t00 * v0a + t01 * v1a + t02 * v2a + COV2D_LOWPASS
    c01 = t10 * v0a + t11 * v1a + t12 * v2a
    c11 = t10 * v0b + t11 * v1b + t12 * v2b + COV2D_LOWPASS
    return c00, c01, c11


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor,
                  world_view: torch.Tensor, focal_x: float, focal_y: float,
                  tan_fovx: float, tan_fovy: float,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """EWA splatting 2D covariance, packed [P, 3] = (xx, xy, yy), with the
    view-space xy clamp and the +0.3 low-pass (forward.cu:74-112): the
    formula of preprocess. `valid` marks the points whose view z may be
    divided by (the others' lanes stay finite)."""
    in_front = torch.ones(means3d.shape[0], dtype=torch.bool,
                          device=means3d.device) if valid is None else valid
    c00, c01, c11 = _cov2d_cols(
        means3d[:, 0], means3d[:, 1], means3d[:, 2], cov3d.unbind(-1),
        world_view, focal_x, focal_y, tan_fovx, tan_fovy, in_front)
    return torch.stack([c00, c01, c11], -1)


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               quats: torch.Tensor, valid: torch.Tensor,
               world_view: torch.Tensor, full_proj: torch.Tensor,
               width: int, height: int, focal_x: float, focal_y: float,
               tan_fovx: float, tan_fovy: float,
               scale_modifier: float = 1.0) -> Preprocessed:
    """Vectorized equivalent of preprocessCUDA (forward.cu:156-256)."""
    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    wv = world_view
    view_z = wv[2, 0] * x + wv[2, 1] * y + wv[2, 2] * z + wv[2, 3]
    in_front = view_z > NEAR_CLIP

    cov6 = _cov3d_cols(scales, quats, scale_modifier)
    c00, c01, c11 = _cov2d_cols(x, y, z, cov6, world_view, focal_x,
                                focal_y, tan_fovx, tan_fovy, in_front)
    c00 = torch.where(in_front, c00, 1.0)
    c01 = torch.where(in_front, c01, 1.0)
    c11 = torch.where(in_front, c11, 1.0)

    det = c00 * c11 - c01 * c01
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, 1.0)
    conic = torch.stack([c11 * det_inv, -c01 * det_inv, c00 * det_inv], -1)

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, RADIUS_EIG_GUARD))
    lam_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    pix, _, _ = project_points(means3d, full_proj, width, height)
    pix = torch.where(in_front[:, None], pix, -1e6)

    mask = valid & in_front & det_valid & (radius_f > 0.0)
    # the tile-rect cull (rect area 0) happens in binning, where the tile
    # grid is known; the reference zeroes the radius there too
    radius = torch.where(mask, radius_f, 0.0).to(torch.int32)
    return Preprocessed(
        mean2d=pix, conic=conic, depth=view_z, radius=radius, mask=mask)
