"""Mapper-side keyframe store: device tensors + training budgets.

Counterpart of legslam_tpu/mapper/keyframe.py (GaussianKeyframe,
src/gaussian_keyframe.cpp, and the mapper's ingestion path,
gaussian_mapper.cpp:361-514): pose, camera transform tensors, the GT image
pyramid on the device, the per-keyframe times-of-use budget and the
pyramid sub-level budgets (getCurrentGausPyramidLevel,
gaussian_keyframe.cpp:195-204).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from legslam_torch.slam.interface import KeyframePacket
from legslam_torch.utils.camera import CameraView, focal2fov


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for float
    [H, W] or [H, W, C] images, on the host: half-pixel bilinear sampling
    with edge clamping and no antialiasing (the JAX module calls cv2 where
    it is installed)."""
    x = torch.as_tensor(np.asarray(img, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)[0]
    return (y[0] if np.ndim(img) == 2 else y.permute(1, 2, 0)).numpy()


@dataclasses.dataclass
class MapKeyframe:
    fid: int
    timestamp: float
    R: np.ndarray                      # [3,3] world->camera
    t: np.ndarray                      # [3]
    views: list                        # CameraView per pyramid level
    gt_color: list                     # device [H,W,3] per level
    gt_depth: list                     # device [H,W] per level
    mask: list                         # device [H,W] per level
    gt_lf: Optional[torch.Tensor]      # [37,37,64] device or None
    kp_pixels: Optional[np.ndarray]
    kp_points_local: Optional[np.ndarray]
    remaining_times_of_use: int = 0
    pyramid_uses: Optional[list] = None  # per-sub-level remaining budgets
    done_inactive_geo_densify: bool = False
    creation_iter: int = 0
    is_loop_kf: bool = False
    # eval bookkeeping (render_time.txt / psnr.txt artifacts)
    record: dict = dataclasses.field(default_factory=dict)

    def set_pose(self, R: np.ndarray, t: np.ndarray, fx: float, fy: float
                 ) -> None:
        """Update pose after BA (computeTransformTensors,
        gaussian_keyframe.cpp:111-145)."""
        self.R, self.t = R, t
        self.views = [CameraView.create(R, t, v.width, v.height, fovx=v.fovx,
                                        fovy=v.fovy,
                                        device=v.world_view.device)
                      for v in self.views]

    def pick_pyramid_level(self) -> int:
        """Consume a sub-level budget; full resolution once exhausted
        (gaussian_keyframe.cpp:195-204: level index 0 is the COARSEST)."""
        if self.pyramid_uses:
            for i, n in enumerate(self.pyramid_uses):
                if n > 0:
                    self.pyramid_uses[i] -= 1
                    return i
        return len(self.pyramid_uses) if self.pyramid_uses else 0


def build_keyframe(packet: KeyframePacket, intr: dict,
                   num_sub_levels: int, pyramid_uses: tuple,
                   times_of_use: int, creation_iter: int,
                   mask_full: Optional[np.ndarray] = None,
                   device: str | torch.device = "cuda") -> MapKeyframe:
    """Snapshot a bridge packet into device-resident pyramids.

    Pyramid levels: sub-level i has scale 2^-(num_sub_levels - i), i.e. for
    2 sub-levels: level 0 = quarter res, level 1 = half res, level 2
    (implicit) = full res (gaussian_mapper.cpp:454-491). Levels are resized
    and quantised on the host, as the JAX module does: color to 8-bit (the
    reference trains from 8-bit images), depth to u16 millimetres when it
    fits (0.5 mm quantisation). The division back to float also runs on
    the host (IEEE float32, as the CPU and JAX divide): CUDA divides by a
    scalar through its reciprocal, an ulp away, so a keyframe built on the
    card would not equal the CPU's. An all-ones mask is made on the
    device.
    """
    h, w = packet.color.shape[:2]
    fx, fy = intr["fx"], intr["fy"]
    fovx, fovy = focal2fov(fx, w), focal2fov(fy, h)
    if mask_full is None:
        mask_full = np.ones((h, w), np.float32)
    depth = packet.depth if packet.depth is not None else \
        np.zeros((h, w), np.float32)

    views, colors, depths, masks = [], [], [], []
    for lvl in range(num_sub_levels + 1):
        if lvl < num_sub_levels:
            scale = 0.5 ** (num_sub_levels - lvl)
            lh, lw = max(int(h * scale), 1), max(int(w * scale), 1)
        else:
            lh, lw = h, w
        views.append(CameraView.create(packet.R, packet.t, lw, lh,
                                       fovx=fovx, fovy=fovy, device=device))
        if (lh, lw) == (h, w):
            c, d, m = packet.color, depth, mask_full
        else:
            c = resize_linear(packet.color, lh, lw)
            d = resize_linear(depth, lh, lw)
            m = resize_linear(mask_full, lh, lw)
        cu8 = np.clip(np.asarray(c, np.float32) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
        colors.append(torch.as_tensor(
            cu8.astype(np.float32) / np.float32(255.0), device=device))
        d = np.asarray(d, np.float32)
        if d.size and np.all(d >= 0) and np.all(d < 65.5):
            dq = (d * 1000.0 + 0.5).astype(np.uint16)
            depths.append(torch.as_tensor(
                dq.astype(np.float32) / np.float32(1000.0), device=device))
        else:
            depths.append(torch.as_tensor(d, device=device))
        m = np.asarray(m, np.float32)
        if np.all(m == 1.0):
            masks.append(torch.ones(lh, lw, device=device))
        else:
            masks.append(torch.as_tensor(m, device=device))

    gt_lf = None
    if packet.lf_image is not None:
        gt_lf = torch.as_tensor(packet.lf_image, device=device,
                                dtype=torch.float32)

    return MapKeyframe(
        fid=packet.fid, timestamp=packet.timestamp, R=packet.R, t=packet.t,
        views=views, gt_color=colors, gt_depth=depths, mask=masks,
        gt_lf=gt_lf, kp_pixels=packet.kp_pixels,
        kp_points_local=packet.kp_points_local,
        remaining_times_of_use=times_of_use,
        pyramid_uses=list(pyramid_uses[:num_sub_levels]),
        creation_iter=creation_iter, is_loop_kf=packet.is_loop_kf)
