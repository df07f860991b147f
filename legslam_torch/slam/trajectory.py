"""Trajectory-driven SLAM frontend: GT/precomputed poses + corner keypoints.

A copy of legslam_tpu/slam/trajectory.py. Where cv2 is not installed,
detect_keypoints takes its grid branch.

Stands in for the ORB-SLAM3 tracking frontend (SURVEY.md §1 L5) when poses
are known (Replica traj.txt, ScanNet pose/, or an external tracker's
output). It reproduces the frontend's *output contract*: keyframe decisions,
colored sparse map points triangulated at keypoints (MapPoint color mod,
ORB-SLAM3/src/MapPoint.cc:135-141), keypoint pixel/local-point export
(KeyFrame::GetKeypointInfo), and LocalMappingBA-style MappingOperations
pushed to the queue (ORB-SLAM3/src/LocalMapping.cc:149-159).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from legslam_torch.data.datasets import RGBDFrame
from legslam_torch.slam.interface import (
    KeyframePacket,
    MappingOperation,
    OperationQueue,
    OpKind,
)

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def detect_keypoints(color: np.ndarray, max_corners: int = 800,
                     min_distance: int = 7) -> np.ndarray:
    """[N,2] corner pixels (x,y). Shi-Tomasi corners as the stand-in for
    ORB keypoints (only positions and depths matter downstream)."""
    if _HAS_CV2:
        gray = (color.mean(-1) * 255).astype(np.uint8)
        pts = cv2.goodFeaturesToTrack(gray, max_corners, 0.01, min_distance)
        if pts is None:
            return np.zeros((0, 2), np.float32)
        return pts.reshape(-1, 2).astype(np.float32)
    h, w = color.shape[:2]  # pragma: no cover — grid fallback
    ys, xs = np.mgrid[4:h:16, 4:w:16]
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)


class TrajectoryFrontend:
    """Feeds frames, decides keyframes, emits MappingOperations.

    Keyframe policy: every `kf_stride` frames (the reference relies on
    ORB-SLAM3's own policy; a fixed stride is the standard evaluation
    protocol for GT-pose mapping runs).
    """

    def __init__(self, intrinsics: dict, kf_stride: int = 8,
                 max_corners: int = 800, min_depth: float = 1e-6,
                 max_depth: float = 40.0, map_point_ratio: float = 0.25):
        self.queue = OperationQueue()
        self.intr = intrinsics
        self.kf_stride = kf_stride
        self.max_corners = max_corners
        self.min_depth = min_depth
        self.max_depth = max_depth
        # fraction of keypoints promoted to map points; the rest stay
        # untriangulated (z = -1) and feed the mapper's inactive-geometry
        # densification, like ORB-SLAM3's sparse triangulation
        self.map_point_ratio = map_point_ratio
        self._n_keyframes = 0

    def track(self, frame: RGBDFrame,
              lf_image: Optional[np.ndarray | torch.Tensor] = None
              ) -> Optional[KeyframePacket]:
        """Process one frame; returns the KeyframePacket if it became a KF."""
        if frame.c2w is None:
            raise ValueError("TrajectoryFrontend needs GT/precomputed poses")
        if frame.index % self.kf_stride != 0:
            return None
        w2c = np.linalg.inv(frame.c2w).astype(np.float32)
        R, t = w2c[:3, :3], w2c[:3, 3]

        kp = detect_keypoints(frame.color, self.max_corners)
        fx, fy = self.intr["fx"], self.intr["fy"]
        cx, cy = self.intr["cx"], self.intr["cy"]
        pts_local = np.full((kp.shape[0], 3), -1.0, np.float32)
        colors = np.zeros((kp.shape[0], 3), np.float32)
        if frame.depth is not None and kp.shape[0]:
            xi = np.clip(kp[:, 0].astype(int), 0, frame.color.shape[1] - 1)
            yi = np.clip(kp[:, 1].astype(int), 0, frame.color.shape[0] - 1)
            d = frame.depth[yi, xi]
            ok = (d > self.min_depth) & (d < self.max_depth)
            # promote only a subset to map points (ORB-SLAM triangulates
            # sparsely); the remainder are exported with z = -1 for the
            # mapper's inactive-geo densify (gaussian_mapper.cpp:1253-1492)
            stride = max(int(round(1.0 / max(self.map_point_ratio, 1e-6))),
                         1)
            promoted = np.zeros_like(ok)
            promoted[::stride] = True
            ok = ok & promoted
            z = np.where(ok, d, -1.0)
            pts_local[:, 0] = np.where(ok, (kp[:, 0] - cx) / fx * d, -1.0)
            pts_local[:, 1] = np.where(ok, (kp[:, 1] - cy) / fy * d, -1.0)
            pts_local[:, 2] = z
            colors = frame.color[yi, xi]

        packet = KeyframePacket(
            fid=frame.index, timestamp=frame.timestamp, R=R, t=t,
            color=frame.color, depth=frame.depth, lf_image=lf_image,
            kp_pixels=kp, kp_points_local=pts_local)

        # sparse colored world points for this KF (MapPoint equivalents)
        valid = pts_local[:, 2] > 0
        if valid.any():
            cam = pts_local[valid]
            # p_world = R^T (p_cam - t)
            world = (cam - t) @ R
            pts_xyz = world.astype(np.float32)
            pts_col = colors[valid]
        else:
            pts_xyz = np.zeros((0, 3), np.float32)
            pts_col = np.zeros((0, 3), np.float32)

        self.queue.push(MappingOperation(
            kind=OpKind.LOCAL_BA, keyframes=[packet],
            points_xyz=pts_xyz, points_color=pts_col))
        self._n_keyframes += 1
        return packet

    def finish(self) -> None:
        self.queue.shutdown()

    @property
    def num_keyframes(self) -> int:
        return self._n_keyframes
