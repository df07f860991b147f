"""Camera math: world2view, OpenGL-style projection, fov conversions.

Parity references:
  - getWorld2View2: src/gaussian_keyframe.cpp:147-169
  - getProjectionMatrix (z in [0,1], z_sign=+1): src/gaussian_keyframe.cpp:171-192
  - fov2focal/focal2fov: include/graphics_utils.h:39-43
  - ndc2Pix: cuda_rasterizer/auxiliary.h:41-44

Matrices are in column-vector convention: p_cam = W2V @ p_w,
p_hom = P @ p_cam.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from legslam_torch.config import Z_FAR, Z_NEAR


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world2view(R: np.ndarray, t: np.ndarray,
               trans: Optional[np.ndarray] = None,
               scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from (R, t), the camera center optionally
    shifted by `trans` and scaled by `scale` (gaussian_keyframe.cpp:147-169)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    center = C2W[:3, 3]
    if trans is not None:
        center = center + trans
    center = center * scale
    C2W[:3, 3] = center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(fovx: float, fovy: float,
                      znear: float = Z_NEAR, zfar: float = Z_FAR) -> np.ndarray:
    """OpenGL-style projection with z mapped to [0,1], z_sign=+1
    (gaussian_keyframe.cpp:171-192)."""
    tan_x = math.tan(fovx / 2.0)
    tan_y = math.tan(fovy / 2.0)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """((v + 1) * S - 1) * 0.5  (auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5


@dataclasses.dataclass(frozen=True)
class CameraView:
    """A posed pinhole view: the raster settings of
    gaussian_renderer.cpp:24-80, with its matrices on one device."""

    width: int
    height: int
    fovx: float
    fovy: float
    world_view: torch.Tensor   # [4,4] world->camera
    full_proj: torch.Tensor    # [4,4] P @ world_view
    cam_center: torch.Tensor   # [3]

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx / 2.0)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy / 2.0)

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    @staticmethod
    def create(R: np.ndarray, t: np.ndarray, width: int, height: int,
               fovx: Optional[float] = None, fovy: Optional[float] = None,
               fx: Optional[float] = None, fy: Optional[float] = None,
               znear: float = Z_NEAR, zfar: float = Z_FAR,
               device: str | torch.device = "cuda") -> "CameraView":
        if fovx is None:
            fovx = focal2fov(fx, width)
        if fovy is None:
            fovy = focal2fov(fy, height)
        w2v = world2view(R, t)
        proj = projection_matrix(fovx, fovy, znear, zfar)
        full = (proj @ w2v).astype(np.float32)
        cam_center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)
        return CameraView(
            width=int(width), height=int(height), fovx=float(fovx),
            fovy=float(fovy),
            world_view=torch.as_tensor(w2v, device=device),
            full_proj=torch.as_tensor(full, device=device),
            cam_center=torch.as_tensor(cam_center, device=device))
