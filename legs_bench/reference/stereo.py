"""The plain reference of the stereo cell: semi-global matching of a
rectified grey pair, and the points a keyframe's keypoints give from a
disparity image.

SGM, as the program computes it (legslam_torch/ops/stereo.py) and the
reference calls it in the stereo densify (cv::cuda::StereoSGM,
gaussian_mapper.cpp:1302-1329): a census transform of each image, the
Hamming cost of every pixel and disparity, four aggregation paths with
penalties P1 for a step of one disparity and P2 for a larger one, and
winner-take-all with a parabola through the winner and its neighbours.
Here each path is its own straight loop over its axis, one step a column
or a row, in float32 (the costs and penalties are integers, so every sum
is exact); nothing of the program is imported.

Where the program's SGM, and so this reference, departs from the
reference's OpenCV call:
  - census over a 5 x 5 window (24 bits, a bit set where the neighbour is
    darker than the centre, the border replicated), where OpenCV's CUDA
    SGM takes a 9 x 7 window;
  - a pixel whose match would fall left of the right image costs the
    largest Hamming distance, 24;
  - no uniqueness-ratio test (OpenCV's default 5%), no left-right
    consistency check and no 3 x 3 median filter on the disparity;
  - the subpixel offset is the parabola's, in float32 and clamped to
    half a pixel, where OpenCV returns 1/16-pixel fixed point;
  - an invalid pixel reads -1: a disparity outside (min_disp,
    num_disp - 1), where OpenCV writes (min_disp - 1) x 16.
The four paths (left to right, right to left, top to bottom, bottom to
top) are OpenCV's MODE_HH4, and P1 = 10, P2 = 120 its defaults.

Back-projection (legslam_torch/slam/trajectory.py in stereo mode, and the
mapper's stereo branch, legslam_torch/mapper/mapper.py): a keypoint reads
the disparity d under its truncated pixel; where d is valid its depth is
z = fx * b / d. Every MAP_POINT_STRIDE-th keypoint with a valid d and z in
(FRONTEND_MIN_DEPTH, FRONTEND_MAX_DEPTH) is a map point; every keypoint
with a valid d, map point or not, is the keyframe's inactive geometry.
"""
from __future__ import annotations

import numpy as np
import torch

P1, P2 = 10.0, 120.0
WINDOW = 5
MAX_COST = 24.0
# ITU-R BT.601 luma, the grey of the stereo branch
LUMA = (0.299, 0.587, 0.114)
# the trajectory frontend's defaults (legslam_torch/slam/trajectory.py)
FRONTEND_MIN_DEPTH = 1e-6
FRONTEND_MAX_DEPTH = 40.0
MAP_POINT_STRIDE = 4


def gray(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W] luma of an [H, W, 3] float image."""
    return LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1] + \
        LUMA[2] * rgb[..., 2]


def census(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 24] bool census of an [H, W] float image: neighbour darker
    than the centre, the neighbours in row order, the border
    replicated."""
    h, w = img.shape
    r = WINDOW // 2
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)
    bits = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            yy = (ys + dy).clamp(0, h - 1)
            xx = (xs + dx).clamp(0, w - 1)
            bits.append(img[yy][:, xx] < img)
    return torch.stack(bits, -1)


def cost_volume(cl: torch.Tensor, cr: torch.Tensor,
                num_disp: int) -> torch.Tensor:
    """[H, W, D] float32 Hamming distance between the left census at x and
    the right census at x - d; MAX_COST where x - d < 0."""
    h, w, _ = cl.shape
    cost = torch.full((h, w, num_disp), MAX_COST, dtype=torch.float32,
                      device=cl.device)
    for d in range(min(num_disp, w)):
        cost[:, d:, d] = (cl[:, d:] != cr[:, :w - d]).sum(-1).float()
    return cost


def _step(prev: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """min(L(d), L(d-1) + P1, L(d+1) + P1, min L + P2) - min L over the
    last axis of the previous step's [N, D] path costs (a missing
    neighbour at either end of the range does not count)."""
    inf = torch.full_like(prev[:, :1], float("inf"))
    lower = torch.cat([inf, prev[:, :-1]], 1)
    upper = torch.cat([prev[:, 1:], inf], 1)
    low = prev.min(1, keepdim=True).values
    best = torch.minimum(torch.minimum(prev, low + p2),
                         torch.minimum(lower, upper) + p1)
    return best - low


def path_left_right(cost, p1=P1, p2=P2):
    out = torch.empty_like(cost)
    out[:, 0] = cost[:, 0]
    for x in range(1, cost.shape[1]):
        out[:, x] = cost[:, x] + _step(out[:, x - 1], p1, p2)
    return out


def path_right_left(cost, p1=P1, p2=P2):
    out = torch.empty_like(cost)
    w = cost.shape[1]
    out[:, w - 1] = cost[:, w - 1]
    for x in range(w - 2, -1, -1):
        out[:, x] = cost[:, x] + _step(out[:, x + 1], p1, p2)
    return out


def path_top_bottom(cost, p1=P1, p2=P2):
    out = torch.empty_like(cost)
    out[0] = cost[0]
    for y in range(1, cost.shape[0]):
        out[y] = cost[y] + _step(out[y - 1], p1, p2)
    return out


def path_bottom_top(cost, p1=P1, p2=P2):
    out = torch.empty_like(cost)
    h = cost.shape[0]
    out[h - 1] = cost[h - 1]
    for y in range(h - 2, -1, -1):
        out[y] = cost[y] + _step(out[y + 1], p1, p2)
    return out


PATHS = (path_left_right, path_right_left, path_top_bottom,
         path_bottom_top)


def aggregate(left: torch.Tensor, right: torch.Tensor, num_disp: int,
              paths=PATHS, dtype=torch.float32) -> torch.Tensor:
    """[H, W, D] sum of the paths' costs for an [H, W] grey pair, the
    paths computed in `dtype`."""
    cost = cost_volume(census(left), census(right), num_disp).to(dtype)
    agg = torch.zeros_like(cost)
    for path in paths:
        agg = agg + path(cost)
    return agg


def winner(agg: torch.Tensor, num_disp: int, min_disp: int
           ) -> torch.Tensor:
    """[H, W] float32 disparity: the least aggregated cost (the lowest d
    of a tie) plus the parabola's offset through its neighbours (each
    clamped into the range), -1 outside (min_disp, num_disp - 1)."""
    agg = agg.float()
    d0 = agg.argmin(-1)
    c0 = agg.gather(-1, d0[..., None])[..., 0]
    cm = agg.gather(-1, (d0 - 1).clamp(0, num_disp - 1)[..., None])[..., 0]
    cp = agg.gather(-1, (d0 + 1).clamp(0, num_disp - 1)[..., None])[..., 0]
    curve = torch.clamp(cm - 2.0 * c0 + cp, min=1e-6)
    offset = torch.clamp((cm - cp) / (2.0 * curve), -0.5, 0.5)
    disp = d0.float() + offset
    ok = (disp > min_disp) & (disp < num_disp - 1)
    return torch.where(ok, disp, torch.full_like(disp, -1.0))


def disparity(left_rgb: torch.Tensor, right_rgb: torch.Tensor,
              num_disp: int, min_disp: int, paths=PATHS,
              dtype=torch.float32) -> torch.Tensor:
    """SGM disparity of a rectified [H, W, 3] pair, TF32 off."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        agg = aggregate(gray(left_rgb.float()), gray(right_rgb.float()),
                        num_disp, paths, dtype)
        return winner(agg, num_disp, min_disp)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def keypoint_disparity(kp: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """The disparity under each [N, 2] keypoint (its truncated pixel,
    clamped to the image)."""
    h, w = disp.shape
    xi = np.clip(kp[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(kp[:, 1].astype(np.int32), 0, h - 1)
    return disp[yi, xi]


def keypoint_points(kp: np.ndarray, d: np.ndarray, color: np.ndarray,
                    c2w: np.ndarray, intr: dict, baseline: float,
                    dtype=np.float64) -> dict:
    """A stereo keyframe's map points and inactive geometry from the
    disparity `d` under each keypoint: {"map": (xyz, rgb), "inactive":
    (xyz, rgb)}, positions in world metres computed in `dtype` from the
    float32 world-to-camera pose the frontend hands on; also "z", each
    keypoint's depth (-1 where d is invalid)."""
    h, w = color.shape[:2]
    xi = np.clip(kp[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(kp[:, 1].astype(np.int32), 0, h - 1)
    valid = d > 0
    dd = d.astype(dtype)
    fx, fy = dtype(intr["fx"]), dtype(intr["fy"])
    cx, cy = dtype(intr["cx"]), dtype(intr["cy"])
    z = np.where(valid, fx * dtype(baseline) / np.where(valid, dd, 1.0),
                 -1.0)
    promoted = np.zeros(len(kp), bool)
    promoted[::MAP_POINT_STRIDE] = True
    is_map = promoted & valid & (z > FRONTEND_MIN_DEPTH) & \
        (z < FRONTEND_MAX_DEPTH)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    R, t = w2c[:3, :3].astype(dtype), w2c[:3, 3].astype(dtype)
    k = kp.astype(dtype)

    def world(m):
        cam = np.stack([(k[m, 0] - cx) / fx * z[m],
                        (k[m, 1] - cy) / fy * z[m], z[m]], -1)
        return (cam - t) @ R
    return {"map": (world(is_map), color[yi[is_map], xi[is_map]]),
            "inactive": (world(valid), color[yi[valid], xi[valid]]),
            "z": z}
