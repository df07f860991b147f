"""The plain reference of how the store grows in the RGB-D loop: the
points a keyframe brings (its map points, and its inactive geometry
through the depth cache) and the count a densification leaves.

Ingest (legslam_torch/slam/trajectory.py TrajectoryFrontend.track and
legslam_torch/mapper/mapper.py handle_operation, _ingest_keyframe,
_cache_inactive_geometry, _rgbd_inactive_geometry, _flush_depth_cache,
after gaussian_mapper.cpp:1253-1492): each keypoint of a keyframe reads
the depth under it. Every `MAP_POINT_STRIDE`-th keypoint with a depth in
(FRONTEND_MIN_DEPTH, FRONTEND_MAX_DEPTH) is a map point and goes into the
store with the keyframe. The others with a depth in the configuration's
(RGBD.min_depth, RGBD.max_depth) are the keyframe's inactive geometry:
cached, and every `Mapper.depth_cache` keyframes with some the cache goes
into the store in one batch, when it holds at least
`min_num_inactive_geo_densify` points. Inside one keyframe's operation
the cache is flushed first, then the map points go in. A point is
back-projected with the keyframe's pose; its colour is the frame's
under the keypoint.

Densify (legslam_torch/models/gaussians.py densify_and_prune, after
gaussian_model.cpp:729-832): gaussians whose mean gradient reaches the
threshold are cloned (largest scale at most percent_dense x extent) or
split into two children (the original pruned); then every gaussian whose
opacity is under the minimum goes, and, once big points are pruned, those
over the screen size or 0.1 x extent. New rows take free slots lowest
first and drop past the capacity.

Plain numpy and torch; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

# TrajectoryFrontend's defaults (legslam_torch/slam/trajectory.py:59-60)
FRONTEND_MIN_DEPTH = 1e-6
FRONTEND_MAX_DEPTH = 40.0
MAP_POINT_STRIDE = 4            # round(1 / map_point_ratio 0.25)
SH_C0 = 0.28209479177387814


def keypoint_points(kp: np.ndarray, color: np.ndarray, depth: np.ndarray,
                    c2w: np.ndarray, intr: dict, min_depth: float,
                    max_depth: float, dtype=np.float64) -> dict:
    """A keyframe's map points and inactive geometry: {"map": (xyz, rgb),
    "inactive": (xyz, rgb)}, positions in world metres computed in
    `dtype` from the float32 world-to-camera pose the frontend hands on."""
    h, w = depth.shape
    xi = np.clip(kp[:, 0].astype(int), 0, w - 1)
    yi = np.clip(kp[:, 1].astype(int), 0, h - 1)
    d = depth[yi, xi]
    promoted = np.zeros(len(kp), bool)
    promoted[::MAP_POINT_STRIDE] = True
    is_map = promoted & (d > FRONTEND_MIN_DEPTH) & (d < FRONTEND_MAX_DEPTH)
    inactive = ~is_map & (d > min_depth) & (d < max_depth)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    R, t = w2c[:3, :3].astype(dtype), w2c[:3, 3].astype(dtype)
    k = kp.astype(dtype)
    dd = d.astype(dtype)
    fx, fy = dtype(intr["fx"]), dtype(intr["fy"])
    cx, cy = dtype(intr["cx"]), dtype(intr["cy"])

    def world(m):
        cam = np.stack([(k[m, 0] - cx) / fx * dd[m],
                        (k[m, 1] - cy) / fy * dd[m], dd[m]], -1)
        return (cam - t) @ R
    return {"map": (world(is_map), color[yi[is_map], xi[is_map]]),
            "inactive": (world(inactive),
                         color[yi[inactive], xi[inactive]])}


class DepthCache:
    """The depth cache's rule, replayed keyframe by keyframe."""

    def __init__(self, depth_cache: int, min_points: int, pending: list,
                 since: int):
        self.depth_cache, self.min_points = depth_cache, min_points
        self.pending, self.since = list(pending), since

    def keyframe(self, points: dict) -> list:
        """The batches (xyz, rgb) that go into the store with this
        keyframe's operation, in order."""
        out = []
        xyz, rgb = points["inactive"]
        if len(xyz):
            self.pending.append((xyz, rgb))
            self.since += 1
            if self.since >= self.depth_cache:
                batch = (np.concatenate([p for p, _ in self.pending]),
                         np.concatenate([c for _, c in self.pending]))
                self.pending, self.since = [], 0
                if len(batch[0]) >= self.min_points:
                    out.append(batch)
        xyz, rgb = points["map"]
        if len(xyz) >= self.min_points:
            out.append((xyz, rgb))
        return out


def rows_gap(batches: list, xyz: torch.Tensor, f_dc: torch.Tensor) -> float:
    """The rows an operation added (in slot order: free slots go lowest
    first, batch after batch) against the reference's batches: the
    largest |difference| of a position (m) or a colour; infinite when the
    counts differ."""
    if not batches:
        return 0.0 if len(xyz) == 0 else float("inf")
    want_xyz = np.concatenate([b[0] for b in batches])
    want_rgb = np.concatenate([b[1] for b in batches]).astype(np.float64)
    if len(want_xyz) != len(xyz):
        return float("inf")
    got_xyz = xyz.detach().cpu().double().numpy()
    got_rgb = f_dc.detach().cpu().double().reshape(-1, 3).numpy() * SH_C0 \
        + 0.5
    return float(max(np.abs(got_xyz - want_xyz).max(),
                     np.abs(got_rgb - want_rgb).max()))


def densified_count(pre: dict, grad_threshold: float, min_opacity: float,
                    extent: float, max_screen_size, percent_dense: float
                    ) -> int:
    """The store's valid count after one densify-and-prune of `pre`
    (opacity, scaling, grad_accum, denom, max_radii2d, valid)."""
    valid = pre["valid"]
    cap = valid.shape[0]
    grads = torch.nan_to_num(pre["grad_accum"] /
                             torch.clamp_min(pre["denom"], 1e-12), nan=0.0)
    scales = torch.exp(pre["scaling"])
    max_scale = scales.max(dim=-1).values
    hot = valid & (grads >= grad_threshold)
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)
    low = torch.sigmoid(pre["opacity"][:, 0]) < min_opacity

    def big(scale):
        if max_screen_size is None:
            return torch.zeros_like(valid)
        return scale.max(dim=-1).values > 0.1 * extent

    def placed(want, free):
        return want & (torch.cumsum(want.to(torch.int64), 0) <= free)

    free = cap - int(valid.sum())
    kept = valid & ~split & ~low & ~big(scales)
    if max_screen_size is not None:
        kept = kept & ~(pre["max_radii2d"] > max_screen_size)
    n = int(kept.sum())
    got = placed(clone, free)
    free -= int(got.sum())
    n += int((got & ~low & ~big(scales)).sum())
    child_scales = torch.exp(torch.log(scales / (0.8 * 2)))
    for _ in range(2):
        got = placed(split, free)
        free -= int(got.sum())
        n += int((got & ~low & ~big(child_scales)).sum())
    return n


def densify_due(start: int, end: int, from_iter: int, until_iter: int,
                interval: int) -> list:
    """The iterations in (start, end] after which the schedule densifies
    (gaussian_mapper.cpp:737-760)."""
    return [i for i in range(start + 1, end + 1)
            if i < until_iter and i > from_iter and i % interval == 0]
