"""Undistortion maps + valid masks (C15, include/camera.h:68-110).

A copy of legslam_tpu/utils/undistort.py.

The reference builds cv::initUndistortRectifyMap maps from the
radial-tangential distortion model, remaps RGB and depth keyframe images
with bilinear interpolation (gaussian_mapper.cpp:399-432; the 37x37 LF
image is NOT undistorted), and derives the binary-ish valid mask by
remapping an all-white image (camera.h:84-85) — resized per pyramid level
(camera.h:87-99). The masks multiply the rendered tensors in the training
loss (gaussian_mapper.cpp:711-721).

This is a host-side preprocessing step (one remap per incoming keyframe),
so plain vectorized numpy is the right tool — the device-side hot path
only ever sees the already-undistorted arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def distort_normalized(x: np.ndarray, y: np.ndarray,
                       dist: Sequence[float]) -> tuple[np.ndarray, np.ndarray]:
    """Apply the OpenCV radial-tangential model (k1, k2, p1, p2[, k3]) to
    ideal normalized coordinates."""
    d = list(dist) + [0.0] * (5 - len(dist))
    k1, k2, p1, p2, k3 = d[:5]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def undistort_rectify_map(K_old: np.ndarray, dist: Sequence[float],
                          K_new: np.ndarray, width: int, height: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap equivalent (R = I): for every
    destination pixel, unproject with K_new, distort, reproject with K_old.
    Returns (map_x, map_y) float32 [H, W] source coordinates."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    xd, yd = distort_normalized(x, y, dist)
    map_x = (K_old[0, 0] * xd + K_old[0, 2]).astype(np.float32)
    map_y = (K_old[1, 1] * yd + K_old[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
                   ) -> np.ndarray:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT 0) equivalent for [H, W] or
    [H, W, C] float arrays."""
    h, w = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0).astype(np.float32)
    fy = (map_y - y0).astype(np.float32)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if img.ndim == 3:
            return np.where(inside[..., None], vals, 0.0)
        return np.where(inside, vals, 0.0)

    wx = fx[..., None] if img.ndim == 3 else fx
    wy = fy[..., None] if img.ndim == 3 else fy
    out = (tap(y0, x0) * (1 - wx) * (1 - wy) +
           tap(y0, x0 + 1) * wx * (1 - wy) +
           tap(y0 + 1, x0) * (1 - wx) * wy +
           tap(y0 + 1, x0 + 1) * wx * wy)
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Undistortion:
    """Per-camera undistortion state (Camera fields, camera.h:130-133)."""
    map_x: np.ndarray
    map_y: np.ndarray
    valid_mask: np.ndarray  # [H, W] float32 in [0, 1]

    def undistort_image(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, self.map_x, self.map_y)


def build_undistortion(intr: dict) -> Optional[Undistortion]:
    """Build maps + mask from an intrinsics dict carrying `dist_coeffs`
    (k1, k2, p1, p2[, k3]); returns None for the pinhole/no-distortion case
    so callers can skip the remap entirely."""
    dist = intr.get("dist_coeffs")
    if dist is None or not np.any(np.asarray(dist)):
        return None
    w, h = int(intr["width"]), int(intr["height"])
    K = np.array([[intr["fx"], 0.0, intr["cx"]],
                  [0.0, intr["fy"], intr["cy"]],
                  [0.0, 0.0, 1.0]], np.float64)
    map_x, map_y = undistort_rectify_map(K, dist, K, w, h)
    white = np.ones((h, w), np.float32)
    mask = remap_bilinear(white, map_x, map_y)
    return Undistortion(map_x=map_x, map_y=map_y, valid_mask=mask)
