"""Depth reprojection, monocular depth borrow, and SGM stereo.

Counterpart of legslam_tpu/ops/stereo.py, as torch ops on the inputs'
device (the reference: src/stereo_vision.cu and the mapper's stereo
densify branch):
  - reproject_depth_pinhole (:40-61): masked depth -> camera-local 3D.
  - mono_borrow_depth (:63-139): keypoints WITHOUT depth take the depth of
    the nearest keypoint WITH depth within `max_pixel_dist`, as one masked
    pairwise-distance matrix and an argmin.
  - sgm_disparity (the reference drives OpenCV's CUDA SGM,
    gaussian_mapper.cpp:1302-1329): 5x5 census transform, Hamming cost
    volume, 4-path dynamic-programming aggregation, winner-take-all with
    parabolic subpixel refinement.

The census is built in int32 (24 bits; torch has no shifts or compares
on uint32) and the Hamming cost uses a SWAR popcount, bit for bit the
JAX uint32 census and lax.population_count. The costs and penalties are
integers, so the f32 aggregation is exact and the integer disparities
equal JAX's; only the parabolic subpixel term may differ by rounding.

Two routes, chosen by device. CUDA tensors take the kernel route
(ops/cuda/sgm.py, legslam_torch/csrc/sgm.cu): census, the four path scans
with the Hamming cost computed on the fly, and winner-take-all, in three
launches, a warp a scanline; its disparity equals the plain version's bit
for bit. CPU tensors take the plain version, the twin the tests hold the
kernels to (sgm_aggregate, disparity_from_aggregate). Its aggregation is
a sequential scan over the image axis, one Python loop that advances all
four paths at once: the two horizontal paths (rows, forward and
reversed) and the two vertical ones (columns, forward and reversed) are
stacked as independent sequences, the shorter ones padded at their END,
which leaves every real step's value unchanged, so a frame takes
max(H, W) - 1 steps of a few tensor ops each. Other devices raise.

Who runs SGM: on the default path (slam/trajectory.py TrajectoryFrontend
in stereo mode) the frontend matches each keyframe's pair once and hands
the disparity on in its KeyframePacket; the mapper's stereo branch reads
it from there, as the reference's densify reads the keyframe it was given.
Non-keyframes run no SGM. The mapper matches a pair itself only for a
packet that carries none (the visual frontend's, slam/tracking.py, which
also runs SGM on every frame for its own depth).

Spans (utils/runtime.py): `stereo.sgm` (keyframe, width, height,
disparities, steps) with `sgm.census`, `sgm.cost`, `sgm.aggregate` and
`sgm.disparity` inside it; the kernel route has no `sgm.cost` (the cost is
computed inside the path scans).
"""
from __future__ import annotations

import torch

from legslam_torch.ops.cuda import sgm as sgm_kernels
from legslam_torch.utils import runtime

# the grey weights of the stereo branch (ITU-R BT.601 luma)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[H, W] grey image of an [H, W, 3] float RGB image, on its device."""
    return rgb @ torch.tensor(GRAY_WEIGHTS, device=rgb.device)


def reproject_depth_pinhole(pixels: torch.Tensor, depths: torch.Tensor,
                            fx: float, fy: float, cx: float, cy: float,
                            valid: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """[N,2] pixels + [N] depths -> [N,3] camera-local points; invalid
    entries get z = -1 (the reference's no-point convention)."""
    if valid is None:
        valid = depths > 0
    x = (pixels[:, 0] - cx) / fx * depths
    y = (pixels[:, 1] - cy) / fy * depths
    pts = torch.stack([x, y, depths], -1)
    return torch.where(valid[:, None], pts, pts.new_full((3,), -1.0))


def mono_borrow_depth(pixels: torch.Tensor, depths: torch.Tensor,
                      has_depth: torch.Tensor, max_pixel_dist: float,
                      fx: float, fy: float, cx: float, cy: float):
    """Monocular inactive-geometry densify: for each keypoint without depth,
    borrow the nearest (pixel-space) keypoint's depth within
    max_pixel_dist and reproject (stereo_vision.cu:63-139).

    Returns ([N,3] camera points with z=-1 where nothing was borrowed,
    [N] bool borrowed-mask).
    """
    n = pixels.shape[0]
    d2 = ((pixels[:, None, :] - pixels[None, :, :]) ** 2).sum(-1)
    inf = torch.tensor(float("inf"), device=pixels.device)
    d2 = torch.where(has_depth[None, :], d2, inf)
    # a keypoint never borrows from itself (diagonal): the reference scans
    # other keypoints only
    eye = torch.eye(n, dtype=torch.bool, device=pixels.device)
    d2 = d2 + torch.where(eye, inf, torch.zeros((), device=pixels.device))
    near_d2, nearest = torch.min(d2, dim=1)
    ok = (~has_depth) & (near_d2 <= max_pixel_dist ** 2) & \
        torch.isfinite(near_d2)
    borrowed = depths[nearest]
    pts = reproject_depth_pinhole(pixels, borrowed, fx, fy, cx, cy,
                                  valid=ok)
    return pts, ok


# ---------------------------------------------------------------------------
# Semi-global matching (stereo densify branch, gaussian_mapper.cpp:1302-1405)
# ---------------------------------------------------------------------------

def census_transform(gray: torch.Tensor, window: int = 5) -> torch.Tensor:
    """[H, W] grayscale -> int32 census bitstrings (window^2-1 bits, at
    most 24 for the default window): bit set where the neighbor is darker
    than the center. Edge-padded."""
    h, w = gray.shape
    r = window // 2
    gp = torch.nn.functional.pad(gray[None, None], (r, r, r, r),
                                 mode="replicate")[0, 0]
    bits = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nb = gp[r + dy:r + dy + h, r + dx:r + dx + w]
            bits |= (nb < gray).to(torch.int32) << k
            k += 1
    return bits


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int32 (SWAR; no multiply, so nothing
    overflows)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _hamming_cost_volume(cl: torch.Tensor, cr: torch.Tensor,
                         num_disp: int) -> torch.Tensor:
    """[H, W] census pair -> [H, W, D] uint8 matching cost
    (popcount(cl ^ cr shifted by d); out-of-image gets the max cost 24)."""
    h, w = cl.shape
    cost = torch.full((h, w, num_disp), 24, dtype=torch.uint8,
                      device=cl.device)
    for d in range(num_disp):
        if d == 0:
            cost[:, :, 0] = popcount32(cl ^ cr).to(torch.uint8)
        elif d < w:
            cost[:, d:, d] = popcount32(cl[:, d:] ^ cr[:, :w - d]) \
                .to(torch.uint8)
    return cost


def _aggregate_dir(cost: torch.Tensor, p1: float, p2: float,
                   reverse: bool) -> torch.Tensor:
    """One SGM path along axis 1 of cost [N, L, D]: the classic recurrence
    L(p,d) = C + min(Lp(d), Lp(d+-1)+P1, min Lp + P2) - min Lp."""
    xs = cost.float().movedim(1, 0)                  # [L, N, D]
    if reverse:
        xs = xs.flip(0)
    outs = _scan(xs, p1, p2)
    if reverse:
        outs = outs.flip(0)
    return outs.movedim(0, 1)                        # [N, L, D]


def _scan(xs: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The SGM recurrence over axis 0 of xs [L, N, D] (f32), with the
    first step as its initial value."""
    outs = torch.empty_like(xs)
    outs[0] = xs[0]
    nd = xs.shape[2]
    nbr = torch.empty_like(xs[0])
    for i in range(1, xs.shape[0]):
        prev = outs[i - 1]
        lo = prev.amin(-1, keepdim=True)             # [N, 1]
        # min of the two disparity neighbours; at an end the one neighbour
        # is replicated, as the JAX concatenation does
        torch.minimum(prev[:, 2:], prev[:, :-2], out=nbr[:, 1:nd - 1])
        torch.minimum(prev[:, 1:2], prev[:, 0:1], out=nbr[:, 0:1])
        torch.minimum(prev[:, nd - 1:], prev[:, nd - 2:nd - 1],
                      out=nbr[:, nd - 1:])
        best = torch.minimum(torch.minimum(prev, lo + p2), nbr + p1)
        torch.sub(xs[i] + best, lo, out=outs[i])
    return outs


def _aggregate_all(cost: torch.Tensor, p1: float, p2: float
                   ) -> torch.Tensor:
    """Sum of the four paths (left->right, right->left, top->bottom,
    bottom->top) of cost [H, W, D], in one scan of max(H, W) - 1 steps:
    each path is a set of independent sequences, stacked; the shorter
    sequences are padded at their end, which no real step reads."""
    h, w, nd = cost.shape
    c = cost.float()
    length = max(h, w)
    rows = c.movedim(1, 0)                           # [W, H, D]
    cols = c                                         # [H, W, D]
    seq = c.new_zeros((length, 2 * h + 2 * w, nd))
    seq[:w, 0:h] = rows
    seq[:w, h:2 * h] = rows.flip(0)
    seq[:h, 2 * h:2 * h + w] = cols
    seq[:h, 2 * h + w:] = cols.flip(0)
    out = _scan(seq, p1, p2)
    # the JAX package adds the paths in this order: rows fwd, rows rev,
    # cols fwd, cols rev (integers: any order is exact)
    agg = out[:w, 0:h].movedim(0, 1) + out[:w, h:2 * h].flip(0).movedim(0, 1)
    agg = agg + out[:h, 2 * h:2 * h + w]
    agg = agg + out[:h, 2 * h + w:].flip(0)
    return agg


def sgm_aggregate(left_gray: torch.Tensor, right_gray: torch.Tensor,
                  num_disp: int = 128, p1: float = 10.0,
                  p2: float = 120.0) -> torch.Tensor:
    """The [H, W, D] f32 aggregated SGM cost of a grayscale pair: census,
    Hamming volume, the sum of the four paths. Integer-valued, so exact
    on every device."""
    with runtime.span("sgm.census"):
        cl = census_transform(left_gray.float())
        cr = census_transform(right_gray.float())
    with runtime.span("sgm.cost"):
        cost = _hamming_cost_volume(cl, cr, num_disp)    # [H, W, D]
    with runtime.span("sgm.aggregate"):
        return _aggregate_all(cost, p1, p2)


def sgm_disparity(left_gray: torch.Tensor, right_gray: torch.Tensor,
                  num_disp: int = 128, min_disp: int = 8,
                  p1: float = 10.0, p2: float = 120.0,
                  keyframe: int | None = None) -> torch.Tensor:
    """SGM disparity for [H, W] grayscale pair; returns [H, W] float32 with
    parabolic subpixel refinement, invalid (<= min_disp or >= num_disp or
    weak) pixels set to -1 like OpenCV's out-of-range convention.
    `keyframe` is the frame id the `stereo.sgm` span records. CUDA
    tensors take the kernels, CPU tensors the plain version (module
    docstring)."""
    h, w = left_gray.shape
    with runtime.span("stereo.sgm", keyframe=keyframe, width=w, height=h,
                      disparities=num_disp, steps=max(h, w) - 1):
        if left_gray.device.type != "cpu":
            return sgm_kernels.sgm(left_gray, right_gray, num_disp,
                                   min_disp, p1, p2)
        agg = sgm_aggregate(left_gray, right_gray, num_disp, p1, p2)
        with runtime.span("sgm.disparity"):
            return disparity_from_aggregate(agg, num_disp, min_disp)


def disparity_from_aggregate(agg: torch.Tensor, num_disp: int,
                             min_disp: int) -> torch.Tensor:
    """Winner-take-all over the [H, W, D] aggregated cost with parabolic
    subpixel refinement; -1 outside (min_disp, num_disp - 1)."""
    d0 = agg.argmin(-1)
    # parabola through (d0-1, d0, d0+1)
    dm = (d0 - 1).clamp(0, num_disp - 1)
    dp = (d0 + 1).clamp(0, num_disp - 1)
    cm = agg.gather(-1, dm[..., None])[..., 0]
    c0 = agg.gather(-1, d0[..., None])[..., 0]
    cp = agg.gather(-1, dp[..., None])[..., 0]
    denom = torch.clamp(cm - 2 * c0 + cp, min=1e-6)
    sub = (0.5 * (cm - cp) / denom).clamp(-0.5, 0.5)
    disp = d0.float() + sub
    ok = (disp > min_disp) & (disp < num_disp - 1)
    return torch.where(ok, disp, torch.full_like(disp, -1.0))


def stereo_inactive_geo_densify(left_rgb: torch.Tensor,
                                right_rgb: torch.Tensor,
                                kp_pixels: torch.Tensor,
                                fx: float, fy: float, cx: float, cy: float,
                                baseline: float,
                                num_disp: int = 128, min_disp: int = 8,
                                disparity: torch.Tensor | None = None):
    """Stereo branch of increasePcdByKeyframeInactiveGeoDensify
    (gaussian_mapper.cpp:1302-1405): SGM disparity from the rectified pair,
    keep only KEYPOINT pixels whose disparity is in (min_disp, num_disp),
    back-project z = fx*b/disp, color from the left image. A `disparity`
    the frontend already computed for this pair is used as it is, and
    `right_rgb` is not read.

    Returns ([N,3] camera-local points with z=-1 where invalid,
    [N,3] colors, [N] bool valid)."""
    disp = disparity if disparity is not None else sgm_disparity(
        to_gray(left_rgb), to_gray(right_rgb), num_disp=num_disp,
        min_disp=min_disp)
    xi, yi = keypoint_index(kp_pixels, disp.shape)
    z, ok = keypoint_depth(disp, xi, yi, fx, baseline)
    pts = reproject_depth_pinhole(kp_pixels, z, fx, fy, cx, cy, valid=ok)
    cols = left_rgb[yi, xi]
    return pts, cols, ok


def keypoint_index(kp_pixels: torch.Tensor, shape) -> tuple:
    """(x, y) long pixel indices of [N, 2] keypoints in an image of
    `shape` (H, W): truncated and clamped to the image."""
    h, w = shape[:2]
    xi = kp_pixels[:, 0].to(torch.int32).clamp(0, w - 1).long()
    yi = kp_pixels[:, 1].to(torch.int32).clamp(0, h - 1).long()
    return xi, yi


def keypoint_depth(disp: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                   fx: float, baseline: float) -> tuple:
    """([N] depth z = fx * b / d, -1 where the disparity under the keypoint
    is invalid; [N] bool valid)."""
    d = disp[yi, xi]
    ok = d > 0
    z = torch.where(ok, fx * baseline / torch.clamp(d, min=1e-6),
                    torch.full_like(d, -1.0))
    return z, ok
