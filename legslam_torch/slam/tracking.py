"""Visual RGB-D tracking frontend: poses WITHOUT ground truth.

Counterpart of the reference's modified ORB-SLAM3 fork (C17 in
SURVEY.md §2; `ORB-SLAM3/src/Tracking.cc:1626-1692` tracking,
`src/LocalMapping.cc:149-159` local BA + op push,
`src/KeyFrame.cc` keypoint export, `Atlas.h:52-170` MappingOperation).
This is a re-design, not a port: instead of ORB descriptors + DBoW2 + g2o,
it uses

  * Shi-Tomasi corners + pyramidal KLT feature tracks (frame-to-frame),
  * RGB-D landmark anchoring: every tracked feature is a *landmark* with a
    world position; per-frame pose solves the 3D-3D alignment of landmark
    world points to their current camera-frame lifts (depth from the
    sensor) with RANSAC + Kabsch — the RGB-D analogue of motion-only BA,
  * keyframe decisions by track attrition / parallax / pose delta
    (Tracking::NeedNewKeyFrame semantics, simplified),
  * a sliding-window local BA: block-coordinate descent alternating
    closed-form landmark updates (robust mean of per-KF backprojections)
    and closed-form pose updates (Kabsch against the refreshed landmarks)
    — the refined poses are re-published through LOCAL_BA MappingOperations
    exactly like the reference's Optimizer::LocalBundleAdjustment out-param
    (`ORB-SLAM3/src/Optimizer.cc:1479-1502`),
  * redundancy-based keyframe culling feeding the queue's live set
    (KeyFrameCulling: a KF dies when >=90% of its landmarks are seen by >=3
    other KFs), which is what makes `GaussianMapper.cull_keyframes` real,
  * pose-proximity + appearance loop detection with a Kabsch correction,
    published as a LOOP_CLOSE_BA op (LoopClosing.cc:1027-1034 contract).

The mapper consumes the exact same OperationQueue contract as the
GT-trajectory frontend, so the two are drop-in interchangeable.

A copy of legslam_tpu/slam/tracking.py: the tracker is host numpy, and
its RANSACs draw from a numpy Generator seeded as in the JAX package, so
both give the same operation stream. Two departures: the stereo depth runs
the port's SGM (ops/stereo.py) on `device` ("cuda" unless the caller asks
for the CPU), and the native route (the C++ kernels of
legslam_torch/csrc/tracking_core.cpp, taken when LEGSLAM_NATIVE_TRACKING=1
or cv2 is absent) raises when its library cannot be built or loaded; it
never drops to another corner detector or tracker.
"""
from __future__ import annotations

import dataclasses
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


def _use_native() -> bool:
    """The C++ kernels (csrc/tracking_core.cpp via slam/native.py) when
    opted in with LEGSLAM_NATIVE_TRACKING=1 or when OpenCV is absent; the
    native calls raise if the library cannot be built or loaded."""
    import os
    return os.environ.get("LEGSLAM_NATIVE_TRACKING") == "1" or not _HAS_CV2


# ---------------------------------------------------------------------------
# Feature detection / tracking primitives
# ---------------------------------------------------------------------------

def to_gray(color: np.ndarray) -> np.ndarray:
    """uint8 gray image of a float [H, W, 3] (or [H, W]) frame in [0, 1].
    Integer frames raise: the in-place steps below would wrap their sum
    and cannot divide them in place."""
    if not np.issubdtype(color.dtype, np.floating):
        raise TypeError(f"to_gray takes a float32 frame in [0, 1], not "
                        f"{color.dtype}")
    if color.ndim == 3:
        # ((c0+c1+c2))/3 — bit-identical to color.mean(-1) (same add
        # order) but 6x faster (no strided reduce machinery); in-place
        # follow-ups avoid three full-frame temporaries on the online
        # loop's per-frame hot path
        g = color[..., 0] + color[..., 1]
        g += color[..., 2]
        g /= 3.0
        np.clip(g, 0.0, 1.0, out=g)
        g *= 255.0
        return g.astype(np.uint8)
    return (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8)


def detect_corners(gray: np.ndarray, max_corners: int,
                   min_distance: int = 7,
                   avoid: Optional[np.ndarray] = None) -> np.ndarray:
    """[N,2] (x,y) Shi-Tomasi corners, avoiding existing track positions."""
    if _use_native():
        from legslam_torch.slam import native
        pts = native.detect_corners(gray.astype(np.float32) / 255.0,
                                    max_corners, min_distance)
        if avoid is not None and len(avoid) and len(pts):
            d2 = ((pts[:, None] - avoid[None]) ** 2).sum(-1)
            pts = pts[d2.min(1) >= min_distance ** 2]
        return pts
    mask = None
    if avoid is not None and len(avoid):
        mask = np.full(gray.shape, 255, np.uint8)
        for x, y in avoid:
            cv2.circle(mask, (int(x), int(y)), min_distance, 0, -1)
    pts = cv2.goodFeaturesToTrack(gray, max_corners, 0.01, min_distance,
                                  mask=mask)
    if pts is None:
        return np.zeros((0, 2), np.float32)
    return pts.reshape(-1, 2).astype(np.float32)


def klt_track(prev_gray: np.ndarray, cur_gray: np.ndarray,
              pts: np.ndarray, fast: bool = False
              ) -> tuple[np.ndarray, np.ndarray]:
    """Track pts [N,2] from prev to cur. Returns (new_pts, ok_mask).

    `fast=True` is the per-frame profile for the online loop's
    frame-to-frame step: a 15x15 window and 12 solver iterations
    (vs the robust 21x21/30 used for init / relocalization / loop
    verification) — measured equal tracking quality on the bench orbit
    at ~60% of the cost; the small inter-frame motion there converges in
    a few iterations anyway."""
    if len(pts) == 0:
        return pts, np.zeros((0,), bool)
    if _use_native():
        from legslam_torch.slam import native
        nxt, ok = native.klt_track(prev_gray.astype(np.float32) / 255.0,
                                   cur_gray.astype(np.float32) / 255.0,
                                   pts, win=7 if fast else 10,
                                   iters=12 if fast else 30)
        h, w = cur_gray.shape
        ok &= (nxt[:, 0] >= 1) & (nxt[:, 0] < w - 1) & \
              (nxt[:, 1] >= 1) & (nxt[:, 1] < h - 1)
        return nxt, ok
    nxt, st, _ = cv2.calcOpticalFlowPyrLK(
        prev_gray, cur_gray, pts.reshape(-1, 1, 2), None,
        winSize=(15, 15) if fast else (21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                  12 if fast else 30, 0.03 if fast else 0.01))
    nxt = nxt.reshape(-1, 2)
    ok = st.reshape(-1).astype(bool)
    h, w = cur_gray.shape
    ok &= (nxt[:, 0] >= 1) & (nxt[:, 0] < w - 1) & \
          (nxt[:, 1] >= 1) & (nxt[:, 1] < h - 1)
    return nxt.astype(np.float32), ok


def klt_track_fb(prev_gray: np.ndarray, cur_gray: np.ndarray,
                 pts: np.ndarray, fb_th: float = 1.0
                 ) -> tuple[np.ndarray, np.ndarray]:
    """KLT with forward-backward verification: track prev->cur->prev and
    keep only round-trips within fb_th pixels. Repetitive texture makes
    plain KLT latch onto look-alike corners (gross outliers that poison
    the 8-point essential estimate); the fb check kills them at 2x cost.
    Used on the sensitive paths (mono init, relocalization)."""
    nxt, ok = klt_track(prev_gray, cur_gray, pts)
    if not ok.any():
        return nxt, ok
    back, ok2 = klt_track(cur_gray, prev_gray, nxt)
    rt = np.linalg.norm(back - pts, axis=1)
    return nxt, ok & ok2 & (rt < fb_th)


# ---------------------------------------------------------------------------
# Pose solving: 3D-3D Kabsch + RANSAC
# ---------------------------------------------------------------------------

def rigid_align(A: np.ndarray, B: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) minimizing ||R @ A + t - B||^2 (Kabsch; A, B [N,3])."""
    ca, cb = A.mean(0), B.mean(0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = np.linalg.svd(H.astype(np.float64))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = (Vt.T @ np.diag([1.0, 1.0, d]) @ U.T).astype(np.float32)
    t = (cb - R @ ca).astype(np.float32)
    return R, t


def ransac_rigid(A: np.ndarray, B: np.ndarray, rng: np.random.Generator,
                 iters: int = 192, thresh: float = 0.05,
                 min_inliers: int = 8
                 ) -> tuple[Optional[np.ndarray], Optional[np.ndarray],
                            np.ndarray]:
    """Robust (R, t) with A -> B 3-point RANSAC + two inlier refits.
    Returns (R, t, inlier_mask); R is None when degenerate."""
    n = len(A)
    if n < 3:
        return None, None, np.zeros(n, bool)
    # batched hypothesis evaluation: one [iters,3,3] SVD pass instead of
    # a python loop of tiny SVDs (~40 ms -> ~3 ms per call at the online
    # loop's ~200-point scale). Minimal-sample draw is fully vectorized
    # (iid triples with colliding rows marked degenerate — at n >= ~50
    # a triple collides with probability < 6%, which costs that one of
    # the 192 hypotheses, strictly cheaper than a python loop of
    # rng.choice calls which dominated the call at the 600-track
    # operating point).
    idx = rng.integers(0, n, size=(iters, 3))
    distinct = (idx[:, 0] != idx[:, 1]) & (idx[:, 0] != idx[:, 2]) & \
        (idx[:, 1] != idx[:, 2])
    sa, sb = A[idx].astype(np.float64), B[idx].astype(np.float64)
    ca, cb = sa.mean(1, keepdims=True), sb.mean(1, keepdims=True)
    az, bz = sa - ca, sb - cb
    # degeneracy: matrix_rank(A[idx] - mean) < 2 (numpy default tol)
    sv_a = np.linalg.svd(az, compute_uv=False)
    tol = sv_a[:, :1] * 3 * np.finfo(np.float64).eps
    ok_h = distinct & ((sv_a > tol).sum(1) >= 2)
    H = np.einsum("mij,mik->mjk", az, bz)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.tile(np.eye(3), (iters, 1, 1))
    D[:, 2, 2] = d
    # R = Vt.T @ D @ U.T per hypothesis (rigid_align's Kabsch form)
    R_h = np.einsum("mij,mjk,mlk->mil", Vt.transpose(0, 2, 1), D, U)
    t_h = cb[:, 0] - np.einsum("mij,mj->mi", R_h, ca[:, 0])
    # full-set consensus scoring in f32 (a 128-point subsample stage was
    # tried and REVERTED: marginal consensus sets — low-inlier frames on
    # soft far geometry, exactly the robustness regime — fell under
    # min_inliers when ranked on a subsample). One broadcast matmul for
    # the whole [iters, n] error matrix; f32 halves the old f64 einsum.
    A32, B32 = A.astype(np.float32), B.astype(np.float32)
    R32, t32 = R_h.astype(np.float32), t_h.astype(np.float32)
    err = np.linalg.norm(
        A32 @ R32.transpose(0, 2, 1) + t32[:, None] - B32[None], axis=-1)
    counts = np.where(ok_h, (err < thresh).sum(1), -1)
    best_i = int(np.argmax(counts))
    if counts[best_i] <= 0:
        return None, None, np.zeros(n, bool)
    best_inl = err[best_i] < thresh
    if best_inl.sum() < min_inliers:
        return None, None, best_inl
    R, t = rigid_align(A[best_inl], B[best_inl])
    for _ in range(2):  # refine on refreshed inliers
        err = np.linalg.norm(A32 @ R.T + t - B32, axis=-1)
        inl = err < thresh
        if inl.sum() < 3:
            break
        best_inl = inl
        R, t = rigid_align(A[inl], B[inl])
    return R, t, best_inl


# ---------------------------------------------------------------------------
# Monocular geometry: essential matrix, triangulation, motion-only PnP
# (the 2D counterparts of the RGB-D 3D-3D stack above; the reference's
# monocular path is ORB-SLAM3/src/Tracking.cc MonocularInitialization +
# TwoViewReconstruction + Optimizer::PoseOptimization — redesigned here as
# normalized-8-point RANSAC + DLT + Gauss-Newton, all batched numpy)
# ---------------------------------------------------------------------------

def _hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]], np.float64)


def _rodrigues(w: np.ndarray) -> np.ndarray:
    ang = float(np.linalg.norm(w))
    if ang < 1e-12:
        return np.eye(3)
    K = _hat(w / ang)
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def _essential_lsq(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Least-squares essential matrix from normalized correspondences
    (8-point; rank-2 projection with equalized singular values)."""
    a1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    a2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    A = (a2[:, :, None] * a1[:, None, :]).reshape(len(x1), 9)
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt


def _sampson(E: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    a1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    a2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    Ex1 = a1 @ E.T
    Etx2 = a2 @ E
    num = np.sum(a2 * Ex1, axis=1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 \
        + Etx2[:, 1] ** 2
    return num / np.maximum(den, 1e-12)


def essential_ransac(x1: np.ndarray, x2: np.ndarray,
                     rng: np.random.Generator, iters: int = 256,
                     thresh: float = 2e-6, min_inliers: int = 12
                     ) -> tuple[Optional[np.ndarray], np.ndarray]:
    """RANSAC essential matrix over normalized coords; Sampson gating.
    Returns (E, inlier_mask); E is None when degenerate."""
    n = len(x1)
    if n < 8:
        return None, np.zeros(n, bool)
    best = np.zeros(n, bool)
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        E = _essential_lsq(x1[idx], x2[idx])
        inl = _sampson(E, x1, x2) < thresh
        if inl.sum() > best.sum():
            best = inl
    if best.sum() < min_inliers:
        return None, best
    E = _essential_lsq(x1[best], x2[best])
    for _ in range(2):
        inl = _sampson(E, x1, x2) < thresh
        if inl.sum() < 8:
            break
        best = inl
        E = _essential_lsq(x1[best], x2[best])
    return E, best


def triangulate_two(R2: np.ndarray, t2: np.ndarray, x1: np.ndarray,
                    x2: np.ndarray) -> np.ndarray:
    """DLT triangulation in cam-1's frame with cam2 = [R2|t2] relative to
    cam1 = [I|0]. x1/x2 normalized [N,2]. Returns [N,3] cam-1 points."""
    n = len(x1)
    P2 = np.concatenate([R2, t2[:, None]], 1).astype(np.float64)  # [3,4]
    A = np.zeros((n, 4, 4), np.float64)
    A[:, 0, 0] = -1.0
    A[:, 0, 2] = x1[:, 0]
    A[:, 1, 1] = -1.0
    A[:, 1, 2] = x1[:, 1]
    A[:, 2] = x2[:, 0, None] * P2[2] - P2[0]
    A[:, 3] = x2[:, 1, None] * P2[2] - P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1]
    return (X[:, :3] / np.where(np.abs(X[:, 3:]) < 1e-12, 1e-12,
                                X[:, 3:])).astype(np.float32)


def triangulate_multi(Rs: np.ndarray, ts: np.ndarray, xs: np.ndarray
                      ) -> Optional[np.ndarray]:
    """World-frame DLT from K >= 2 views: Rs [K,3,3] w2c, ts [K,3],
    xs [K,2] normalized observations. Returns [3] or None."""
    rows = []
    for R, t, x in zip(Rs, ts, xs):
        P = np.concatenate([R, t[:, None]], 1).astype(np.float64)
        rows.append(x[0] * P[2] - P[0])
        rows.append(x[1] * P[2] - P[1])
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    return (X[:3] / X[3]).astype(np.float32)


def _essential_candidates(E: np.ndarray) -> list:
    """The four (R, unit t) decompositions of an essential matrix."""
    U, _, Vt = np.linalg.svd(E.astype(np.float64))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    return [(R, t) for R in (U @ W @ Vt, U @ W.T @ Vt)
            for t in (U[:, 2], -U[:, 2])]


def score_pose_candidate(R: np.ndarray, t: np.ndarray, x1: np.ndarray,
                         x2: np.ndarray, reproj_th: float = 8e-3
                         ) -> tuple[np.ndarray, np.ndarray, float]:
    """Triangulate and grade one relative-pose hypothesis. Returns
    (X1 [N,3] cam-1 points, good mask, median parallax angle deg of good
    points). good = positive finite depth in both views + low
    reprojection."""
    R32, t32 = R.astype(np.float32), t.astype(np.float32)
    X = triangulate_two(R32, t32, x1, x2)
    z1 = X[:, 2]
    cam2 = X @ R32.T + t32
    z2 = cam2[:, 2]
    good = (z1 > 1e-3) & (z2 > 1e-3) & (z1 < 1e4)
    with np.errstate(divide="ignore", invalid="ignore"):
        p1 = X[:, :2] / np.where(np.abs(z1[:, None]) < 1e-9, 1e-9,
                                 z1[:, None])
        p2 = cam2[:, :2] / np.where(np.abs(z2[:, None]) < 1e-9, 1e-9,
                                    z2[:, None])
    good &= (np.linalg.norm(p1 - x1, axis=1) < reproj_th)
    good &= (np.linalg.norm(p2 - x2, axis=1) < reproj_th)
    if not good.any():
        return X, good, 0.0
    c2 = -(R32.T @ t32)
    b1 = X[good] / np.maximum(np.linalg.norm(X[good], axis=1,
                                             keepdims=True), 1e-12)
    d2 = X[good] - c2
    b2 = d2 / np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), 1e-12)
    cosang = np.clip(np.median(np.sum(b1 * b2, axis=1)), -1.0, 1.0)
    return X, good, float(np.degrees(np.arccos(cosang)))


def decompose_essential(E: np.ndarray, x1: np.ndarray, x2: np.ndarray
                        ) -> tuple[Optional[np.ndarray],
                                   Optional[np.ndarray], np.ndarray]:
    """Pick the cheirality-consistent (R, t) of the four E decompositions
    (unit-norm t; x2 ~ R @ X + t for X in cam-1 coords). Returns
    (R, t, good_mask) — good = positive finite depth in both views."""
    best = (None, None, np.zeros(len(x1), bool))
    for R, t in _essential_candidates(E):
        X, good, _ = score_pose_candidate(R, t, x1, x2)
        if good.sum() > best[2].sum():
            best = (R.astype(np.float32), t.astype(np.float32), good)
    return best


def _homography_lsq(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """DLT homography from normalized correspondences (x2 ~ H x1)."""
    n = len(x1)
    A = np.zeros((2 * n, 9), np.float64)
    u, v = x1[:, 0], x1[:, 1]
    up, vp = x2[:, 0], x2[:, 1]
    A[0::2, 0] = -u
    A[0::2, 1] = -v
    A[0::2, 2] = -1
    A[0::2, 6] = up * u
    A[0::2, 7] = up * v
    A[0::2, 8] = up
    A[1::2, 3] = -u
    A[1::2, 4] = -v
    A[1::2, 5] = -1
    A[1::2, 6] = vp * u
    A[1::2, 7] = vp * v
    A[1::2, 8] = vp
    _, _, Vt = np.linalg.svd(A)
    return Vt[-1].reshape(3, 3)


def _homography_err(H: np.ndarray, x1: np.ndarray, x2: np.ndarray
                    ) -> np.ndarray:
    """Symmetric transfer error (squared, normalized coords)."""
    a1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    a2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    f = a1 @ H.T
    with np.errstate(divide="ignore", invalid="ignore"):
        f = f[:, :2] / np.where(np.abs(f[:, 2:]) < 1e-12, 1e-12, f[:, 2:])
    Hi = np.linalg.inv(H)
    b = a2 @ Hi.T
    with np.errstate(divide="ignore", invalid="ignore"):
        b = b[:, :2] / np.where(np.abs(b[:, 2:]) < 1e-12, 1e-12, b[:, 2:])
    return np.sum((f - x2) ** 2, 1) + np.sum((b - x1) ** 2, 1)


def homography_ransac(x1: np.ndarray, x2: np.ndarray,
                      rng: np.random.Generator, iters: int = 256,
                      thresh: float = 2e-5, min_inliers: int = 12
                      ) -> tuple[Optional[np.ndarray], np.ndarray]:
    """RANSAC plane homography over normalized coords. Planar scenes make
    the 8-point essential estimate degenerate (a 2-parameter family fits),
    so monocular init selects between E and H like the reference
    (ORB-SLAM3 TwoViewReconstruction computes both and reconstructs from
    the better-scoring model)."""
    n = len(x1)
    if n < 8:
        return None, np.zeros(n, bool)
    best = np.zeros(n, bool)
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        try:
            H = _homography_lsq(x1[idx], x2[idx])
            inl = _homography_err(H, x1, x2) < thresh
        except np.linalg.LinAlgError:
            continue
        if inl.sum() > best.sum():
            best = inl
    if best.sum() < min_inliers:
        return None, best
    H = _homography_lsq(x1[best], x2[best])
    for _ in range(2):
        try:
            inl = _homography_err(H, x1, x2) < thresh
        except np.linalg.LinAlgError:
            break
        if inl.sum() < 8:
            break
        best = inl
        H = _homography_lsq(x1[best], x2[best])
    return H, best


def _homography_candidates(H: np.ndarray) -> list:
    """Faugeras-Lustman SVD decomposition of a normalized-coordinate
    homography into up to 8 (R, t) hypotheses (H = R + t n^T / d;
    textbook method, Faugeras & Lustman 1988)."""
    U, L, Vt = np.linalg.svd(H.astype(np.float64))
    s = np.linalg.det(U) * np.linalg.det(Vt)
    l1, l2, l3 = L
    if l1 - l3 < 1e-9 * l2:   # pure rotation (degenerate for init)
        return []
    a1 = np.sqrt(max((l1 * l1 - l2 * l2) / (l1 * l1 - l3 * l3), 0.0))
    a3 = np.sqrt(max((l2 * l2 - l3 * l3) / (l1 * l1 - l3 * l3), 0.0))
    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1v, x3v = e1 * a1, e3 * a3
            # d' > 0 branch
            st = (l1 - l3) * x1v * x3v / l2
            ct = (l1 * x3v * x3v + l3 * x1v * x1v) / l2
            Rp = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
            tp = (l1 - l3) * np.array([x1v, 0.0, -x3v])
            cands.append((s * U @ Rp @ Vt, U @ tp))
            # d' < 0 branch
            sp = (l1 + l3) * x1v * x3v / l2
            cp = (l3 * x1v * x1v - l1 * x3v * x3v) / l2
            Rn = np.array([[cp, 0, sp], [0, -1, 0], [sp, 0, -cp]])
            tn = (l1 + l3) * np.array([x1v, 0.0, x3v])
            cands.append((s * U @ Rn @ Vt, U @ tn))
    out = []
    for R, t in cands:
        nt = np.linalg.norm(t)
        if nt > 1e-12:
            out.append((R, t / nt))
    return out


def pnp_gn(world: np.ndarray, xn: np.ndarray, R0: np.ndarray,
           t0: np.ndarray, iters: int = 10, huber: float = 5e-3,
           inlier_th: float = 1e-2
           ) -> tuple[Optional[np.ndarray], Optional[np.ndarray],
                      np.ndarray]:
    """Motion-only reprojection Gauss-Newton (3D-2D): minimize
    sum rho(pi(R w + t) - xn) over the 6-dof pose with Huber weights,
    initialized at (R0, t0). The monocular stand-in for ORB-SLAM3's
    Optimizer::PoseOptimization. Returns (R, t, inlier_mask)."""
    n = len(world)
    if n < 6:
        return None, None, np.zeros(n, bool)
    R = R0.astype(np.float64).copy()
    t = t0.astype(np.float64).copy()
    w64 = world.astype(np.float64)
    x64 = xn.astype(np.float64)
    for _ in range(iters):
        p = w64 @ R.T + t
        z = np.maximum(p[:, 2], 1e-6)
        r = np.stack([p[:, 0] / z - x64[:, 0],
                      p[:, 1] / z - x64[:, 1]], -1)     # [n,2]
        rn = np.linalg.norm(r, axis=1)
        wgt = np.where(rn <= huber, 1.0, huber / np.maximum(rn, 1e-12))
        wgt = np.where(p[:, 2] > 1e-6, wgt, 0.0)
        # J = dr/d(dt, omega): [n,2,6] with dp/ddelta = [I, -hat(p)]
        iz = 1.0 / z
        J = np.zeros((n, 2, 6))
        drdp = np.zeros((n, 2, 3))
        drdp[:, 0, 0] = iz
        drdp[:, 0, 2] = -p[:, 0] * iz * iz
        drdp[:, 1, 1] = iz
        drdp[:, 1, 2] = -p[:, 1] * iz * iz
        J[:, :, :3] = drdp
        hats = np.zeros((n, 3, 3))
        hats[:, 0, 1] = -p[:, 2]
        hats[:, 0, 2] = p[:, 1]
        hats[:, 1, 0] = p[:, 2]
        hats[:, 1, 2] = -p[:, 0]
        hats[:, 2, 0] = -p[:, 1]
        hats[:, 2, 1] = p[:, 0]
        J[:, :, 3:] = -np.einsum("nij,njk->nik", drdp, hats)
        Jw = J * wgt[:, None, None]
        H = np.einsum("nij,nik->jk", Jw, J)
        g = np.einsum("nij,ni->j", Jw, r)
        try:
            delta = np.linalg.solve(H + 1e-9 * np.eye(6), -g)
        except np.linalg.LinAlgError:
            return None, None, np.zeros(n, bool)
        Re = _rodrigues(delta[3:])
        R = Re @ R
        t = Re @ t + delta[:3]
        if np.linalg.norm(delta) < 1e-10:
            break
    p = w64 @ R.T + t
    z = np.maximum(p[:, 2], 1e-6)
    r = np.stack([p[:, 0] / z - x64[:, 0], p[:, 1] / z - x64[:, 1]], -1)
    inl = (np.linalg.norm(r, axis=1) < inlier_th) & (p[:, 2] > 1e-6)
    # re-orthonormalize
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    return R.astype(np.float32), t.astype(np.float32), inl


# ---------------------------------------------------------------------------
# The frontend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Landmark:
    world: Optional[np.ndarray]       # [3] world estimate (None: mono,
    #                                   awaiting triangulation)
    color: np.ndarray                 # [3]
    obs: dict                         # kf_fid -> cam-frame point [3] (rgbd)
    created_kf: int
    # kf_fid -> NORMALIZED image obs [2] (monocular observations)
    obs2d: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _KF:
    fid: int
    R: np.ndarray                     # world->camera
    t: np.ndarray
    gray: np.ndarray
    color: np.ndarray
    depth: Optional[np.ndarray]


class TrackingFrontend:
    """RGB-D visual tracking + mapping-op publication (no GT poses)."""

    def __init__(self, intrinsics: dict, max_corners: int = 600,
                 min_depth: float = 1e-4, max_depth: float = 40.0,
                 min_track_ratio: float = 0.55,
                 kf_trans_th: float = 0.15, kf_rot_deg_th: float = 10.0,
                 ransac_thresh: float = 0.05, ba_window: int = 6,
                 ba_sweeps: int = 3, min_inliers: int = 12,
                 cull_redundancy: float = 0.95,
                 loop_min_gap: int = 10, loop_radius: float = 0.3,
                 loop_appearance_th: float = 0.4,
                 loop_desc_th: float = 0.12,
                 loop_consistency: int = 2,
                 enable_loop_closing: bool = True,
                 max_keyframes_live: int = 0, seed: int = 0,
                 sensor: str = "rgbd",
                 reloc_after: int = 2, reanchor_after: int = 12,
                 reloc_appearance_th: float = 0.35,
                 reloc_desc_th: float = 0.10,
                 mono_init_parallax: float = 12.0,
                 mono_depth_gauge: float = 2.5,
                 scale_refine_kfs: int = 3,
                 stereo_baseline: float = 0.0,
                 use_imu: bool = False,
                 gravity_mag: float = 9.81,
                 imu_init_kfs: int = 6,
                 device: str | torch.device = "cuda"):
        # the "-inertial" suffix mirrors the reference's sensor enum
        # (System.h:67-75: IMU_MONOCULAR/IMU_STEREO/IMU_RGBD)
        if sensor.endswith("-inertial"):
            sensor = sensor[:-len("-inertial")]
            use_imu = True
        if sensor not in ("rgbd", "mono", "stereo"):
            raise ValueError(f"unknown sensor mode {sensor!r}")
        self.queue = OperationQueue()
        self.last_vis = None  # viewer SLAM-frame snapshot (_capture_vis)
        self.intr = intrinsics
        self.max_corners = max_corners
        self.min_depth, self.max_depth = min_depth, max_depth
        self.min_track_ratio = min_track_ratio
        self.kf_trans_th = kf_trans_th
        self.kf_rot_deg_th = kf_rot_deg_th
        self.ransac_thresh = ransac_thresh
        self.ba_window = ba_window
        self.ba_sweeps = ba_sweeps
        self.min_inliers = min_inliers
        self.cull_redundancy = cull_redundancy
        self.loop_min_gap = loop_min_gap
        self.loop_radius = loop_radius
        self.loop_appearance_th = loop_appearance_th
        self.loop_desc_th = loop_desc_th
        self.loop_consistency = loop_consistency
        self.enable_loop_closing = enable_loop_closing
        self.max_keyframes_live = max_keyframes_live
        self.sensor = sensor
        self.reloc_after = reloc_after
        self.reanchor_after = reanchor_after
        self.reloc_appearance_th = reloc_appearance_th
        self.reloc_desc_th = reloc_desc_th
        self.mono_init_parallax = mono_init_parallax
        self.mono_depth_gauge = mono_depth_gauge
        self.scale_refine_kfs = scale_refine_kfs
        self.stereo_baseline = stereo_baseline
        self.device = torch.device(device)   # where SGM runs (stereo)
        self._rng = np.random.default_rng(seed)

        self.landmarks: dict[int, _Landmark] = {}
        self._next_lm = 0
        self.keyframes: dict[int, _KF] = {}
        self._kf_order: list[int] = []
        # appearance caches: pooled gray (FFT loop/reloc verification) and
        # a tiny unit-norm thumbnail (vectorized candidate prefilter) per
        # keyframe — recomputing the pooled image for EVERY stored KF per
        # query made loop detection quadratic in map size (the reference
        # caches DBoW2 bow vectors per KF for the same reason,
        # ORB-SLAM3/src/KeyFrame.cc ComputeBoW)
        self._kf_pooled: dict[int, np.ndarray] = {}
        self._kf_thumb: dict[int, np.ndarray] = {}
        # per-KF patch descriptors + keypoint pixels for the
        # place-recognition score (_place_score): pooled correlation alone
        # aliases on repeated structure — descriptors + shift-coherence
        # voting discriminate places that pool similarly but differ in
        # local detail (the role DBoW2 plays in ORB-SLAM3,
        # LoopClosing.cc DetectLoop)
        self._kf_desc: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # temporal consistency of loop candidates (consistency groups,
        # LoopClosing.cc:~DetectLoop): (anchor kf-order index, hits)
        self._loop_pending: Optional[tuple[int, int]] = None
        # active tracks: parallel arrays
        self._track_lm: np.ndarray = np.zeros((0,), np.int64)
        self._track_px: np.ndarray = np.zeros((0, 2), np.float32)
        self._prev_gray: Optional[np.ndarray] = None
        self._last_kf_px_count = 0
        self.poses: dict[int, np.ndarray] = {}  # fid -> c2w (estimated)
        # fid -> (ref KF fid, T_frame_w2c @ inv(T_refkf_w2c)) at track time
        self._frame_ref: dict[int, tuple[int, np.ndarray]] = {}
        self._kf_final: dict[int, np.ndarray] = {}  # culled KFs' last pose
        self._cur_R = np.eye(3, dtype=np.float32)
        self._cur_t = np.zeros(3, np.float32)
        self._cur_right = None         # latest rectified right image (stereo)
        self.lost_frames = 0
        self.n_loop_closures = 0
        self.n_keyframes_created = 0
        # mono state: two-view initialization buffer + metric-scale obs
        self.initialized = sensor != "mono"
        self._mono_ref = None          # (frame, gray, px0, px_cur)
        self._scale_obs: list = []     # depth-borrow scale ratios (mono)
        self.n_scale_refinements = 0
        self.mono_scale = 1.0
        self._lost_streak = 0
        self.n_relocalizations = 0
        self.n_map_resets = 0
        # inertial state (slam/imu.py; Tracking::PredictStateIMU +
        # LocalMapping::InitializeIMU counterparts)
        self.use_imu = use_imu
        self.gravity_mag = gravity_mag
        self.imu_init_kfs = imu_init_kfs
        self.imu_ready = False         # gravity/velocity (and mono scale)
        self._g_w: Optional[np.ndarray] = None
        self._v_w = np.zeros(3, np.float64)
        self._imu_pred = None          # (R_w2c, t_w2c, v_w) this frame
        self._imu_since_kf = None      # merged Preintegrated since last KF
        self._imu_kf_buf: list = []    # (R_wb, p_vis, pre) init windows
        self.n_imu_inits = 0

    # -- geometry helpers ------------------------------------------------
    def _lift(self, px: np.ndarray, depth: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """Pixels [N,2] -> camera-frame 3D via the depth map; mask of valid."""
        h, w = depth.shape
        xi = np.clip(px[:, 0].round().astype(int), 0, w - 1)
        yi = np.clip(px[:, 1].round().astype(int), 0, h - 1)
        d = depth[yi, xi]
        ok = (d > self.min_depth) & (d < self.max_depth) & np.isfinite(d)
        fx, fy = self.intr["fx"], self.intr["fy"]
        cx, cy = self.intr["cx"], self.intr["cy"]
        cam = np.stack([(px[:, 0] - cx) / fx * d,
                        (px[:, 1] - cy) / fy * d, d], -1).astype(np.float32)
        return cam, ok

    @staticmethod
    def _to_world(cam: np.ndarray, R: np.ndarray, t: np.ndarray
                  ) -> np.ndarray:
        return (cam - t) @ R

    def _store_pose(self, fid: int) -> None:
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = self._cur_R.T
        c2w[:3, 3] = -(self._cur_R.T @ self._cur_t)
        self.poses[fid] = c2w
        # store KF-relative so later BA / loop corrections of the reference
        # KF retro-correct the whole frame trajectory (the reference's
        # SaveTrajectoryTUM likewise emits frame poses relative to their
        # reference KF's FINAL pose, ORB-SLAM3/src/System.cc)
        if self._kf_order:
            ref = self.keyframes[self._kf_order[-1]]
            T_kf = np.eye(4, dtype=np.float32)
            T_kf[:3, :3], T_kf[:3, 3] = ref.R, ref.t
            T_f = np.eye(4, dtype=np.float32)
            T_f[:3, :3], T_f[:3, 3] = self._cur_R, self._cur_t
            self._frame_ref[fid] = (ref.fid, T_f @ np.linalg.inv(T_kf))

    def _normalize(self, px: np.ndarray) -> np.ndarray:
        """Pixels [N,2] -> normalized image coordinates [N,2]."""
        fx, fy = self.intr["fx"], self.intr["fy"]
        cx, cy = self.intr["cx"], self.intr["cy"]
        return np.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy],
                        -1).astype(np.float32)

    def _denormalize(self, xn: np.ndarray) -> np.ndarray:
        fx, fy = self.intr["fx"], self.intr["fy"]
        cx, cy = self.intr["cx"], self.intr["cy"]
        return np.stack([xn[:, 0] * fx + cx, xn[:, 1] * fy + cy],
                        -1).astype(np.float32)

    # -- inertial helpers --------------------------------------------------
    def _cur_pose_wb(self) -> tuple[np.ndarray, np.ndarray]:
        """Current pose as (R_wb body-to-world, p_wb world position)."""
        R_wb = self._cur_R.T.astype(np.float64)
        return R_wb, -(R_wb @ self._cur_t.astype(np.float64))

    def _set_pose_from_wb(self, R_wb: np.ndarray, p_wb: np.ndarray) -> None:
        self._cur_R = R_wb.T.astype(np.float32)
        self._cur_t = (-(R_wb.T @ p_wb)).astype(np.float32)

    def _imu_ingest(self, imu: Optional[np.ndarray]) -> None:
        """Per-frame IMU bookkeeping: preintegrate the block, extend the
        since-keyframe accumulation, and (once gravity is initialized)
        predict this frame's pose from the last frame's visual pose
        (Tracking::PredictStateIMU)."""
        self._imu_pred = None
        if not self.use_imu or imu is None:
            return
        from legslam_torch.slam.imu import predict_pose, preintegrate
        pre = preintegrate(imu)
        if pre.n == 0:
            return
        if self._imu_since_kf is not None:
            self._imu_since_kf = self._imu_since_kf.merge(pre)
        elif self._kf_order:
            self._imu_since_kf = pre
        if self.imu_ready and self.keyframes:
            R_wb, p_wb = self._cur_pose_wb()
            R2, p2, v2 = predict_pose(R_wb, p_wb, self._v_w, self._g_w, pre)
            self._imu_pred = (R2, p2, v2, pre.dt, p_wb)

    def _imu_update_velocity(self) -> None:
        """After a successful visual pose solve: world velocity from the
        frame-to-frame position difference over the IMU interval."""
        if not (self.use_imu and self.imu_ready and self._imu_pred):
            return
        _, _, _, dt, p_prev = self._imu_pred
        if dt <= 1e-6:
            return
        _, p_now = self._cur_pose_wb()
        self._v_w = (p_now - p_prev) / dt

    def _imu_collect_init(self, kf: _KF) -> None:
        """Accumulate per-keyframe (pose, preintegration) windows and run
        the closed-form visual-inertial alignment (slam/imu.py). For mono
        the solved scale rescales the map and is published as
        SCALE_REFINEMENT — the reference's IMU-init push
        (LocalMapping.cc:1300-1304)."""
        from legslam_torch.slam.imu import align_visual_inertial
        pre = self._imu_since_kf
        self._imu_since_kf = None
        R_wb = kf.R.T.astype(np.float64)
        p_vis = -(R_wb @ kf.t.astype(np.float64))
        if not self._imu_kf_buf:
            self._imu_kf_buf = [[(R_wb, p_vis)], []]
            return
        states, pres = self._imu_kf_buf
        if pre is None or pre.dt <= 1e-6:   # IMU gap: restart the window
            self._imu_kf_buf = [[(R_wb, p_vis)], []]
            return
        states.append((R_wb, p_vis))
        pres.append(pre)
        if len(states) > self.imu_init_kfs:
            states.pop(0)
            pres.pop(0)
        if len(states) < self.imu_init_kfs:
            return
        est_scale = self.sensor == "mono"
        out = align_visual_inertial(
            [s[0] for s in states], [s[1] for s in states], pres,
            gravity_mag=self.gravity_mag, estimate_scale=est_scale)
        if out is None or out["residual"] > 0.1:
            return
        self._g_w = out["g_w"]
        self._v_w = out["v_w"][-1]
        self.imu_ready = True
        self.n_imu_inits += 1
        self._imu_kf_buf = []
        s = out["scale"]
        if est_scale and abs(s - 1.0) > 0.02 and 0.2 < s < 100.0:
            self._apply_global_scale(s)
            self.mono_scale *= s
            self.n_scale_refinements += 1
            packets = [self._pose_packet(f) for f in self._kf_order]
            self.queue.push(MappingOperation(
                kind=OpKind.SCALE_REFINEMENT, keyframes=packets, scale=s))

    # -- main per-frame entry ---------------------------------------------
    def track(self, frame: RGBDFrame,
              lf_image: Optional[np.ndarray | torch.Tensor] = None,
              color_right: Optional[np.ndarray] = None,
              imu: Optional[np.ndarray] = None
              ) -> Optional[KeyframePacket]:
        """Per-frame entry (System::TrackRGBDLF / TrackMonocular /
        TrackStereo, ORB-SLAM3/src/System.cc). Sensor modes:
          rgbd   — depth map required; 3D-3D landmark-anchored tracking.
          mono   — color only; essential-matrix two-view init, PnP
                   tracking, DLT triangulation; metric scale borrowed
                   from a depth sensor when frames carry one, published
                   as SCALE_REFINEMENT (LocalMapping.cc:1300-1304).
          stereo — rectified right image; depth from the census+SGM
                   stereo kernels, then the RGB-D machinery; the right
                   image rides the packets for the SGM densify branch.
        Each mode has an "-inertial" variant (System.h:67-75): pass
        `imu` = [K, 7] rows (t, gyro, accel) covering the interval since
        the previous frame; gravity/velocity (and monocular scale) are
        initialized by closed-form visual-inertial alignment, after which
        IMU prediction replaces the constant-pose model on lost frames
        and seeds the monocular PnP.
        """
        gray = to_gray(frame.color)
        self._imu_ingest(imu)
        if self.sensor == "stereo":
            if color_right is None:
                raise ValueError("stereo tracking requires color_right")
            depth = self._stereo_depth(frame.color, color_right)
            frame = dataclasses.replace(frame, depth=depth)
            self._cur_right = color_right
        elif self.sensor == "rgbd" and frame.depth is None:
            raise ValueError("rgbd tracking requires depth; use "
                             "sensor='mono' to track without it")
        if self.sensor == "mono":
            return self._track_mono(frame, gray, lf_image)
        return self._track_rgbd(frame, gray, lf_image)

    def _track_rgbd(self, frame: RGBDFrame, gray: np.ndarray,
                    lf_image: Optional[np.ndarray | torch.Tensor]
                    ) -> Optional[KeyframePacket]:
        if not self.keyframes:
            # bootstrap: world frame = first camera frame
            self._cur_R = np.eye(3, dtype=np.float32)
            self._cur_t = np.zeros(3, np.float32)
            self._store_pose(frame.index)
            packet = self._make_keyframe(frame, gray, lf_image)
            self._capture_vis(gray)
            self._prev_gray = gray
            return packet

        # 1. track features frame-to-frame
        new_px, ok = klt_track(self._prev_gray, gray, self._track_px,
                               fast=True)
        self._track_lm = self._track_lm[ok]
        self._track_px = new_px[ok]

        # 2. landmark-anchored pose: world -> current camera 3D-3D
        cam, dep_ok = self._lift(self._track_px, frame.depth)
        world = np.stack([self.landmarks[i].world for i in self._track_lm]) \
            if len(self._track_lm) else np.zeros((0, 3), np.float32)
        use = dep_ok
        R, t, inl = (None, None, None)
        if use.sum() >= 3:
            R, t, inl_sub = ransac_rigid(
                world[use], cam[use], self._rng, thresh=self.ransac_thresh,
                min_inliers=self.min_inliers)
            if R is not None:
                inl = np.zeros(len(self._track_px), bool)
                inl[np.flatnonzero(use)[inl_sub]] = True
        if R is None:
            return self._handle_lost(frame, gray, lf_image)

        self._lost_streak = 0
        self._cur_R, self._cur_t = R, t
        self._imu_update_velocity()
        self._store_pose(frame.index)

        # drop RANSAC outliers with valid depth (bad associations)
        keep = ~(use & ~inl)
        self._track_lm = self._track_lm[keep]
        self._track_px = self._track_px[keep]

        packet = None
        if self._need_keyframe(inl.sum()):
            packet = self._make_keyframe(frame, gray, lf_image)

        self._capture_vis(gray, int(inl.sum()))
        self._prev_gray = gray
        return packet

    # -- lost handling / relocalization ---------------------------------
    def _handle_lost(self, frame: RGBDFrame, gray: np.ndarray,
                     lf_image: Optional[np.ndarray | torch.Tensor]
                     ) -> Optional[KeyframePacket]:
        """Tracking failed this frame. Constant-pose fallback, then after
        `reloc_after` consecutive losses try appearance relocalization
        against the keyframe store (the redesigned Tracking::Relocalization
        — pooled-FFT appearance candidates replace DBoW2, KLT + Kabsch/PnP
        replace the PnPsolver); after `reanchor_after` losses fall back to
        re-anchoring a fresh keyframe at the constant-pose guess so mapping
        continues (the reference would stay lost or spawn a new Atlas
        map)."""
        self.lost_frames += 1
        self._lost_streak += 1
        if self._imu_pred is not None:
            # IMU dead-reckoning through the blackout instead of the
            # constant-pose fallback (Tracking::PredictStateIMU while
            # mState==RECENTLY_LOST)
            R2, p2, v2, _, _ = self._imu_pred
            self._set_pose_from_wb(R2, p2)
            self._v_w = v2
        self._store_pose(frame.index)
        packet = None
        if self._lost_streak >= self.reloc_after:
            if self._relocalize(frame, gray):
                self.n_relocalizations += 1
                self._lost_streak = 0
                self._store_pose(frame.index)
                # rebuild tracks from a fresh keyframe at the recovered pose
                packet = self._make_keyframe(frame, gray, lf_image)
            elif (self._lost_streak >= self.reanchor_after
                  and self.sensor != "mono"
                  and len(detect_corners(gray, 50)) >= self.min_inliers):
                self._lost_streak = 0
                packet = self._make_keyframe(frame, gray, lf_image)
            elif (self._lost_streak >= self.reanchor_after
                  and self.sensor == "mono"):
                # a fresh mono keyframe can't re-anchor (no depth to seed
                # 3D landmarks) — re-run two-view initialization from the
                # constant-pose/IMU guess instead, starting a new map
                # segment while the old keyframes stay frozen for
                # trajectory and loop closing (Atlas::CreateMapInAtlas,
                # Tracking.cc mState==LOST "Starting a new map" branch;
                # like the reference's new Atlas map, the segment carries
                # its own scale gauge until a loop/scale op reconciles it)
                self._lost_streak = 0
                self.initialized = False
                self._mono_ref = None
                self._track_lm = np.zeros((0,), np.int64)
                self._track_px = np.zeros((0, 2), np.float32)
                # drop depth-borrow scale ratios: the new segment gets a
                # fresh median-depth gauge, so old-gauge ratios would bias
                # the next SCALE_REFINEMENT median
                self._scale_obs = []
                self.n_map_resets += 1
        self._capture_vis(gray)
        self._prev_gray = gray
        return packet

    def _register_kf_appearance(self, fid: int, gray: np.ndarray) -> None:
        self._kf_pooled[fid] = _pool_gray(gray)
        self._kf_thumb[fid] = _thumb(gray)
        self._kf_desc[fid] = _patch_descriptors(
            gray, detect_corners(gray, 200))

    def _query_desc(self, gray: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        return _patch_descriptors(gray, detect_corners(gray, 200))

    def _shortlist(self, gray: np.ndarray, fids: list[int], top_m: int
                   ) -> list[int]:
        """Cheap appearance prefilter: rank candidate KFs by thumbnail
        correlation (one vectorized dot product over the whole store) and
        return the best `top_m`. Bounds the number of expensive pooled-FFT
        verifications per query at O(1) instead of O(#keyframes)."""
        if len(fids) <= top_m:
            return list(fids)
        q = _thumb(gray)
        D = np.stack([self._kf_thumb[f] for f in fids])    # [K, 256]
        scores = D @ q
        order = np.argsort(-scores)[:top_m]
        return [fids[i] for i in order]

    def _relocalize(self, frame: RGBDFrame, gray: np.ndarray) -> bool:
        """Pose recovery against the keyframe store. Returns True (and
        updates _cur_R/_cur_t) on success."""
        a = _pool_gray(gray)
        qd, qp = self._query_desc(gray)
        scored = []
        for fid in self._shortlist(gray, self._kf_order, 8):
            pc = _peak_corr(a, self._kf_pooled[fid])
            ent = self._kf_desc.get(fid)
            coh = _place_score(qd, qp, ent[0], ent[1]) if ent else 0.0
            # descriptor coherence ranks first — among look-alike places
            # (similar pooled correlation) it picks the true one; the
            # peak correlation breaks ties and keeps the absolute gate
            scored.append(((coh, pc), fid))
        scored.sort(reverse=True)
        passing = [(k, fid) for k, fid in scored
                   if k[0] >= self.reloc_desc_th
                   and k[1] >= self.reloc_appearance_th]
        for (coh, score), fid in passing[:3]:
            kf = self.keyframes[fid]
            if self.sensor == "mono":
                if self._reloc_mono_against(kf, gray):
                    return True
            elif self._reloc_rgbd_against(kf, frame, gray):
                return True
        return False

    def _reloc_rgbd_against(self, kf: _KF, frame: RGBDFrame,
                            gray: np.ndarray) -> bool:
        pts = detect_corners(kf.gray, 300)
        if len(pts) < self.min_inliers:
            return False
        cur_px, ok = klt_track_fb(kf.gray, gray, pts)
        if ok.sum() < self.min_inliers:
            return False
        cam_old, ok_o = self._lift(pts[ok], kf.depth)
        cam_new, ok_n = self._lift(cur_px[ok], frame.depth)
        use = ok_o & ok_n
        if use.sum() < self.min_inliers:
            return False
        world_old = self._to_world(cam_old[use], kf.R, kf.t)
        R, t, inl = ransac_rigid(world_old, cam_new[use], self._rng,
                                 thresh=self.ransac_thresh,
                                 min_inliers=self.min_inliers)
        if R is None or inl.sum() < self.min_inliers:
            return False
        self._cur_R, self._cur_t = R, t
        # tracks are stale after a blackout — drop them; the reloc
        # keyframe replenishes
        self._track_lm = np.zeros((0,), np.int64)
        self._track_px = np.zeros((0, 2), np.float32)
        return True

    def _reloc_mono_against(self, kf: _KF, gray: np.ndarray) -> bool:
        lm_ids, px_old, world = [], [], []
        for i, lm in self.landmarks.items():
            if lm.world is not None and kf.fid in lm.obs2d:
                lm_ids.append(i)
                px_old.append(lm.obs2d[kf.fid])
                world.append(lm.world)
        if len(lm_ids) < self.min_inliers:
            return False
        px_old = self._denormalize(np.asarray(px_old, np.float32))
        world = np.asarray(world, np.float32)
        cur_px, ok = klt_track_fb(kf.gray, gray, px_old)
        if ok.sum() < self.min_inliers:
            return False
        xn = self._normalize(cur_px[ok])
        R, t, inl = pnp_gn(world[ok], xn, kf.R, kf.t)
        if R is None or inl.sum() < self.min_inliers:
            return False
        self._cur_R, self._cur_t = R, t
        # resume tracking the re-found landmarks
        ids = np.asarray(lm_ids, np.int64)[ok][inl]
        self._track_lm = ids
        self._track_px = cur_px[ok][inl]
        return True

    # -- stereo depth -----------------------------------------------------
    def _stereo_depth(self, color: np.ndarray,
                      color_right: np.ndarray) -> np.ndarray:
        """Census+SGM disparity -> metric depth (ops/stereo.py — the same
        kernels the mapper's stereo densify branch uses,
        src/stereo_vision.cu / cv::cuda::StereoSGM in the reference)."""
        from legslam_torch.ops.stereo import sgm_disparity
        gl = torch.as_tensor(color, device=self.device).mean(-1)
        gr = torch.as_tensor(color_right, device=self.device).mean(-1)
        disp = sgm_disparity(gl, gr).cpu().numpy().astype(np.float32)
        b = self.stereo_baseline or 0.1
        with np.errstate(divide="ignore"):
            depth = self.intr["fx"] * b / np.where(disp > 0, disp, np.inf)
        return depth.astype(np.float32)

    # -- monocular tracking ----------------------------------------------
    def _track_mono(self, frame: RGBDFrame, gray: np.ndarray,
                    lf_image: Optional[np.ndarray | torch.Tensor]
                    ) -> Optional[KeyframePacket]:
        if not self.initialized:
            packet = self._mono_init_step(frame, gray, lf_image)
            self._prev_gray = gray
            return packet

        new_px, ok = klt_track(self._prev_gray, gray, self._track_px,
                               fast=True)
        self._track_lm = self._track_lm[ok]
        self._track_px = new_px[ok]

        has3d = np.asarray(
            [self.landmarks[int(i)].world is not None
             for i in self._track_lm], bool) \
            if len(self._track_lm) else np.zeros((0,), bool)
        R = None
        if has3d.sum() >= 6:
            world = np.stack([self.landmarks[int(i)].world
                              for i in self._track_lm[has3d]])
            xn = self._normalize(self._track_px[has3d])
            # IMU prediction seeds the PnP when available (better basin
            # of attraction than the previous frame's pose under fast
            # motion — Tracking::PredictStateIMU's role)
            if self._imu_pred is not None:
                R0 = self._imu_pred[0].T.astype(np.float32)
                t0 = (-(R0 @ self._imu_pred[1])).astype(np.float32)
            else:
                R0, t0 = self._cur_R, self._cur_t
            R, t, inl_sub = pnp_gn(world, xn, R0, t0)
            if R is not None and inl_sub.sum() < self.min_inliers:
                R = None
        if R is None:
            return self._handle_lost(frame, gray, lf_image)

        self._lost_streak = 0
        self._cur_R, self._cur_t = R, t
        self._imu_update_velocity()
        self._store_pose(frame.index)

        # drop PnP outliers (bad associations)
        keep = np.ones(len(self._track_px), bool)
        keep[np.flatnonzero(has3d)[~inl_sub]] = False
        self._track_lm = self._track_lm[keep]
        self._track_px = self._track_px[keep]

        packet = None
        if self._need_keyframe(int(inl_sub.sum())):
            packet = self._make_keyframe(frame, gray, lf_image)

        self._capture_vis(gray, int(inl_sub.sum()))
        self._prev_gray = gray
        return packet

    def _mono_init_step(self, frame: RGBDFrame, gray: np.ndarray,
                        lf_image: Optional[np.ndarray | torch.Tensor]
                        ) -> Optional[KeyframePacket]:
        """Two-view monocular initialization
        (Tracking::MonocularInitialization): hold a reference frame, KLT
        until median parallax clears the bar, then essential-matrix
        RANSAC + cheirality decomposition + triangulation, gauge-fixed to
        median depth = mono_depth_gauge."""
        if self._mono_ref is None:
            pts = detect_corners(gray, self.max_corners)
            if len(pts) < 4 * self.min_inliers:
                return None
            self._mono_ref = dict(frame=frame, gray=gray, px0=pts,
                                  px=pts.copy(),
                                  R=self._cur_R.copy(),
                                  t=self._cur_t.copy())
            self._store_pose(frame.index)
            return None

        ref = self._mono_ref
        px, ok = klt_track_fb(self._prev_gray, gray, ref["px"])
        ref["px0"], ref["px"] = ref["px0"][ok], px[ok]
        self._store_pose(frame.index)
        if len(ref["px"]) < 4 * self.min_inliers:
            self._mono_ref = None  # reference died; restart
            return None
        parallax = np.median(
            np.linalg.norm(ref["px"] - ref["px0"], axis=1))
        if parallax < self.mono_init_parallax:
            return None

        x1 = self._normalize(ref["px0"])
        x2 = self._normalize(ref["px"])
        # Both models, gates calibrated to ~2 px of KLT noise: the 8-point
        # essential estimate is DEGENERATE on planar (wall-dominated)
        # scenes, so candidate poses come from E *and* the Faugeras
        # decomposition of H, and the reconstruction picks whichever
        # hypothesis triangulates best (ORB-SLAM3 TwoViewReconstruction's
        # H/F model selection, redesigned as a unified candidate score).
        th = (2.0 / self.intr["fx"]) ** 2
        cands = []
        E, inl_e = essential_ransac(x1, x2, self._rng, thresh=th,
                                    min_inliers=4 * self.min_inliers)
        if E is not None:
            cands += [(R, t, inl_e) for R, t in _essential_candidates(E)]
        H, inl_h = homography_ransac(x1, x2, self._rng, thresh=2 * th,
                                     min_inliers=4 * self.min_inliers)
        if H is not None:
            cands += [(R, t, inl_h) for R, t in _homography_candidates(H)]

        best = None  # (n_good, med_par, Rrel, trel, inl, X1, sel)
        for R, t, inl in cands:
            X1, good, med_par = score_pose_candidate(R, t, x1[inl], x2[inl])
            key = (int(good.sum()), med_par)
            if best is None or key > best[0]:
                best = (key, R.astype(np.float32), t.astype(np.float32),
                        inl, X1, good)
        if best is None:
            return None
        (n_good, med_par), Rrel, trel, inl, X1, sel = best
        # acceptance: enough support AND enough PARALLAX ANGLE — raw pixel
        # displacement is rotation-inclusive, so a look-at motion passes
        # the displacement gate while the translation signal is still too
        # weak for a stable reconstruction
        if n_good < 2 * self.min_inliers or med_par < 0.9:
            return None
        # gauge: median triangulated depth -> mono_depth_gauge
        s = self.mono_depth_gauge / max(float(np.median(X1[sel, 2])), 1e-6)
        X1 = X1 * s
        trel = trel * s

        R0, t0 = ref["R"], ref["t"]
        world = self._to_world(X1[sel], R0, t0)
        px_ref = ref["px0"][inl][sel]
        px_cur = ref["px"][inl][sel]
        ref_frame, ref_gray = ref["frame"], ref["gray"]
        h, w = ref_gray.shape
        xi = np.clip(px_ref[:, 0].astype(int), 0, w - 1)
        yi = np.clip(px_ref[:, 1].astype(int), 0, h - 1)
        cols = ref_frame.color[yi, xi].astype(np.float32)

        ids = []
        for j in range(len(world)):
            lm = _Landmark(world=world[j], color=cols[j], obs={},
                           created_kf=ref_frame.index)
            lm.obs2d[ref_frame.index] = self._normalize(px_ref[j:j + 1])[0]
            lm.obs2d[frame.index] = self._normalize(px_cur[j:j + 1])[0]
            self.landmarks[self._next_lm] = lm
            ids.append(self._next_lm)
            self._next_lm += 1

        # keyframe 0 (reference) and keyframe 1 (current)
        kf0 = _KF(fid=ref_frame.index, R=R0.copy(), t=t0.copy(),
                  gray=ref_gray, color=ref_frame.color, depth=None)
        self.keyframes[ref_frame.index] = kf0
        self._kf_order.append(ref_frame.index)
        self.n_keyframes_created += 1
        self._register_kf_appearance(ref_frame.index, ref_gray)

        # current pose: cam2 = Rrel @ cam1 + trel composed with ref pose
        self._cur_R = (Rrel @ R0).astype(np.float32)
        self._cur_t = (Rrel @ t0 + trel).astype(np.float32)
        self._track_lm = np.asarray(ids, np.int64)
        self._track_px = px_cur
        self.initialized = True
        self._mono_ref = None
        self._store_pose(frame.index)
        self._last_kf_px_count = max(len(ids), 1)
        packet = self._make_keyframe(frame, gray, lf_image)
        self._capture_vis(gray, len(ids))
        return packet

    def _capture_vis(self, gray: np.ndarray, n_inliers: int = 0) -> None:
        """Snapshot for the viewer's SLAM-frame pane (the reference's
        ImGui current-frame + keypoint overlay, viewer/imgui_viewer.cpp)."""
        self.last_vis = dict(gray=gray,
                             pts=np.asarray(self._track_px,
                                            np.float32).copy(),
                             inliers=int(n_inliers))

    def _need_keyframe(self, n_inliers: int) -> bool:
        if n_inliers < self.min_track_ratio * self._last_kf_px_count:
            return True
        last = self.keyframes[self._kf_order[-1]]
        dR = self._cur_R @ last.R.T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        # camera-center translation
        c_now = -(self._cur_R.T @ self._cur_t)
        c_last = -(last.R.T @ last.t)
        return (np.linalg.norm(c_now - c_last) > self.kf_trans_th or
                ang > self.kf_rot_deg_th)

    # -- keyframe creation ------------------------------------------------
    def _make_keyframe(self, frame: RGBDFrame, gray: np.ndarray,
                       lf_image: Optional[np.ndarray | torch.Tensor]
                       ) -> KeyframePacket:
        fid = frame.index
        R, t = self._cur_R.copy(), self._cur_t.copy()
        kf = _KF(fid=fid, R=R, t=t, gray=gray, color=frame.color,
                 depth=frame.depth)
        self.keyframes[fid] = kf
        self._kf_order.append(fid)
        self.n_keyframes_created += 1
        self._register_kf_appearance(fid, gray)
        if self.use_imu:
            if self.imu_ready:
                self._imu_since_kf = None
            else:
                self._imu_collect_init(kf)

        if self.sensor == "mono":
            new_xyz, new_col, n_obs_kf = self._mono_observe_and_extend(
                frame, gray, fid)
        else:
            new_xyz, new_col, n_obs_kf = self._rgbd_observe_and_extend(
                frame, gray, fid, R, t)
        # KF-decision reference = usable observations at this KF (what the
        # landmark-anchored / PnP solver can actually use downstream)
        self._last_kf_px_count = max(n_obs_kf, 1)

        # local BA over the sliding window, then publish
        updated = self._local_ba()
        packets = [self._packet_for(fid, frame, lf_image)]
        for ufid in updated:
            if ufid != fid:
                packets.append(self._pose_packet(ufid))
        self.queue.push(MappingOperation(
            kind=OpKind.LOCAL_BA, keyframes=packets,
            points_xyz=np.asarray(new_xyz, np.float32).reshape(-1, 3),
            points_color=np.asarray(new_col, np.float32).reshape(-1, 3)))

        if self.sensor == "mono" and frame.depth is not None:
            # depth-borrow metric-scale refinement (the mono counterpart
            # of the reference's IMU-init ScaleRefinement push,
            # LocalMapping.cc:1300-1304)
            self._mono_scale_update(frame)
        if self.enable_loop_closing:
            self._try_loop_close(kf)
        self._cull_keyframes()
        return packets[0]

    def _rgbd_observe_and_extend(self, frame, gray, fid, R, t):
        # observations for surviving tracks at this KF
        cam, ok = self._lift(self._track_px, frame.depth)
        for i in np.flatnonzero(ok):
            self.landmarks[int(self._track_lm[i])].obs[fid] = cam[i]
        n_obs_kf = int(ok.sum())

        # replenish with fresh corners -> new landmarks
        need = self.max_corners - len(self._track_px)
        new_xyz, new_col = [], []
        if need > 0:
            fresh = detect_corners(gray, need, avoid=self._track_px)
            if len(fresh):
                camf, okf = self._lift(fresh, frame.depth)
                fresh, camf = fresh[okf], camf[okf]
                worldf = self._to_world(camf, R, t)
                h, w = gray.shape
                xi = np.clip(fresh[:, 0].astype(int), 0, w - 1)
                yi = np.clip(fresh[:, 1].astype(int), 0, h - 1)
                cols = frame.color[yi, xi].astype(np.float32)
                ids = []
                for j in range(len(fresh)):
                    lm = _Landmark(world=worldf[j], color=cols[j],
                                   obs={fid: camf[j]}, created_kf=fid)
                    self.landmarks[self._next_lm] = lm
                    ids.append(self._next_lm)
                    self._next_lm += 1
                self._track_lm = np.concatenate(
                    [self._track_lm, np.asarray(ids, np.int64)])
                self._track_px = np.concatenate([self._track_px, fresh])
                new_xyz, new_col = worldf, cols
                n_obs_kf += len(fresh)
        return new_xyz, new_col, n_obs_kf

    def _mono_observe_and_extend(self, frame, gray, fid):
        """Record 2D observations, triangulate matured pending tracks, and
        seed fresh (world-less) landmarks from new corners
        (Tracking/LocalMapping::CreateNewMapPoints semantics)."""
        xn = self._normalize(self._track_px)
        for i, lmid in enumerate(self._track_lm):
            self.landmarks[int(lmid)].obs2d[fid] = xn[i]
        n_obs_kf = int(len(self._track_lm))

        # triangulate pending landmarks that now have >= 2 observations
        new_xyz, new_col = self._mono_triangulate_pending()

        need = self.max_corners - len(self._track_px)
        if need > 0:
            fresh = detect_corners(gray, need, avoid=self._track_px)
            if len(fresh):
                h, w = gray.shape
                xi = np.clip(fresh[:, 0].astype(int), 0, w - 1)
                yi = np.clip(fresh[:, 1].astype(int), 0, h - 1)
                cols = frame.color[yi, xi].astype(np.float32)
                xnf = self._normalize(fresh)
                ids = []
                for j in range(len(fresh)):
                    lm = _Landmark(world=None, color=cols[j], obs={},
                                   created_kf=fid)
                    lm.obs2d[fid] = xnf[j]
                    self.landmarks[self._next_lm] = lm
                    ids.append(self._next_lm)
                    self._next_lm += 1
                self._track_lm = np.concatenate(
                    [self._track_lm, np.asarray(ids, np.int64)])
                self._track_px = np.concatenate([self._track_px, fresh])
        return new_xyz, new_col, n_obs_kf

    def _mono_triangulate_pending(self) -> tuple[list, list]:
        """DLT-triangulate world-less landmarks with >= 2 live-KF
        observations and sufficient parallax; returns their (xyz, color)
        lists (the op's new map points)."""
        new_xyz, new_col = [], []
        for lm in self.landmarks.values():
            if lm.world is not None:
                continue
            fids = [f for f in lm.obs2d if f in self.keyframes]
            if len(fids) < 2:
                continue
            Rs = np.stack([self.keyframes[f].R for f in fids])
            ts = np.stack([self.keyframes[f].t for f in fids])
            xs = np.stack([lm.obs2d[f] for f in fids])
            # parallax gate: bearing angle between first/last observers
            b0 = Rs[0].T @ np.array([xs[0, 0], xs[0, 1], 1.0])
            b1 = Rs[-1].T @ np.array([xs[-1, 0], xs[-1, 1], 1.0])
            cosang = float(b0 @ b1 /
                           (np.linalg.norm(b0) * np.linalg.norm(b1)))
            if cosang > 0.99995:   # < ~0.57 deg of parallax
                continue
            X = triangulate_multi(Rs, ts, xs)
            if X is None:
                continue
            cams = np.einsum("kij,j->ki", Rs, X) + ts
            if np.any(cams[:, 2] < 1e-3):
                continue
            # reprojection check
            proj = cams[:, :2] / cams[:, 2:3]
            if float(np.max(np.linalg.norm(proj - xs, axis=1))) > 2e-2:
                continue
            lm.world = X
            new_xyz.append(X)
            new_col.append(lm.color)
        return new_xyz, new_col

    def _mono_scale_update(self, frame: RGBDFrame) -> None:
        """Compare predicted landmark depths against the frame's metric
        depth sensor; once enough keyframes agree, rescale the whole map +
        trajectory and publish SCALE_REFINEMENT (scale s, identity rigid
        part; the origin KF rides first so the mapper's pose-diff
        reconstruction is exact — mapper._handle_scale_refinement)."""
        ratios = []
        px = self._track_px
        if len(px) == 0:
            return
        h, w = frame.depth.shape
        xi = np.clip(px[:, 0].round().astype(int), 0, w - 1)
        yi = np.clip(px[:, 1].round().astype(int), 0, h - 1)
        d_sensor = frame.depth[yi, xi]
        for i, lmid in enumerate(self._track_lm):
            lm = self.landmarks[int(lmid)]
            if lm.world is None:
                continue
            z = float(self._cur_R[2] @ lm.world + self._cur_t[2])
            ds = float(d_sensor[i])
            if z > 1e-3 and self.min_depth < ds < self.max_depth:
                ratios.append(ds / z)
        if len(ratios) < self.min_inliers:
            return
        self._scale_obs.append(float(np.median(ratios)))
        if len(self._scale_obs) < self.scale_refine_kfs:
            return
        s = float(np.median(self._scale_obs))
        self._scale_obs = []
        if not (0.2 < s < 100.0) or abs(s - 1.0) < 0.02:
            return
        self._apply_global_scale(s)
        self.mono_scale *= s
        self.n_scale_refinements += 1
        packets = [self._pose_packet(f) for f in self._kf_order]
        self.queue.push(MappingOperation(
            kind=OpKind.SCALE_REFINEMENT, keyframes=packets, scale=s))

    def _apply_global_scale(self, s: float) -> None:
        """world <- s * world across landmarks, keyframes, and the stored
        trajectory (w2c translations scale with the map)."""
        for lm in self.landmarks.values():
            if lm.world is not None:
                lm.world = (lm.world * s).astype(np.float32)
            lm.obs = {f: (c * s).astype(np.float32)
                      for f, c in lm.obs.items()}
        for kf in self.keyframes.values():
            kf.t = (kf.t * s).astype(np.float32)
        for f, T in self._kf_final.items():
            T[:3, 3] *= s
        for f, c2w in self.poses.items():
            c2w[:3, 3] *= s
        for f, (ref_fid, T_rel) in self._frame_ref.items():
            T_rel = T_rel.copy()
            T_rel[:3, 3] *= s
            self._frame_ref[f] = (ref_fid, T_rel)
        self._cur_t = (self._cur_t * s).astype(np.float32)
        self._v_w = self._v_w * s   # world velocity rides the map scale

    def _packet_for(self, fid: int, frame: RGBDFrame,
                    lf_image: Optional[np.ndarray | torch.Tensor]
                    ) -> KeyframePacket:
        kf = self.keyframes[fid]
        # keypoint export (KeyFrame::GetKeypointInfo contract): tracked
        # pixels + camera-local points, z=-1 when the landmark has no
        # depth / triangulation yet
        if self.sensor == "mono":
            pts_local = np.full((len(self._track_px), 3), -1.0, np.float32)
            for i, lmid in enumerate(self._track_lm):
                w = self.landmarks[int(lmid)].world
                if w is not None:
                    p = kf.R @ w + kf.t
                    if p[2] > 0:
                        pts_local[i] = p
        else:
            cam, ok = self._lift(self._track_px, frame.depth)
            pts_local = np.where(ok[:, None], cam,
                                 np.full_like(cam, -1.0))
        return KeyframePacket(
            fid=fid, timestamp=float(frame.timestamp), R=kf.R, t=kf.t,
            color=kf.color, depth=kf.depth, lf_image=lf_image,
            color_right=self._cur_right if self.sensor == "stereo"
            else None,
            kp_pixels=self._track_px.copy(), kp_points_local=pts_local)

    def _pose_packet(self, fid: int) -> KeyframePacket:
        kf = self.keyframes[fid]
        return KeyframePacket(
            fid=fid, timestamp=0.0, R=kf.R.copy(), t=kf.t.copy(),
            color=kf.color, depth=kf.depth, lf_image=None)

    # -- local BA ----------------------------------------------------------
    def _local_ba(self) -> list[int]:
        if self.sensor == "mono":
            return self._mono_local_ba()
        return self._rgbd_local_ba()

    def _mono_local_ba(self) -> list[int]:
        """Monocular sliding-window refinement: alternate multi-view DLT
        re-triangulation and per-KF motion-only PnP (the 2D analogue of
        the RGB-D block-coordinate descent below; the reference's
        Optimizer::LocalBundleAdjustment)."""
        window = self._kf_order[-self.ba_window:]
        if len(window) < 2:
            return []
        wset = set(window)
        touched = [lm for lm in self.landmarks.values()
                   if lm.world is not None
                   and any(f in wset for f in lm.obs2d)]
        for _ in range(self.ba_sweeps):
            for lm in touched:
                fids = [f for f in lm.obs2d if f in self.keyframes]
                if len(fids) < 2:
                    continue
                Rs = np.stack([self.keyframes[f].R for f in fids])
                ts = np.stack([self.keyframes[f].t for f in fids])
                xs = np.stack([lm.obs2d[f] for f in fids])
                X = triangulate_multi(Rs, ts, xs)
                if X is not None and np.all(
                        (np.einsum("kij,j->ki", Rs, X) + ts)[:, 2] > 1e-3):
                    lm.world = X
            for f in window[1:]:
                k = self.keyframes[f]
                A, B = [], []
                for lm in touched:
                    if f in lm.obs2d:
                        A.append(lm.world)
                        B.append(lm.obs2d[f])
                if len(A) >= 6:
                    R, t, inl = pnp_gn(np.asarray(A), np.asarray(B),
                                       k.R, k.t)
                    if R is not None and inl.sum() >= self.min_inliers:
                        k.R, k.t = R, t
        newest = self.keyframes[window[-1]]
        self._cur_R, self._cur_t = newest.R.copy(), newest.t.copy()
        return window[1:]

    def _rgbd_local_ba(self) -> list[int]:
        """Sliding-window refinement by block-coordinate descent:
        (a) landmark <- mean of backprojections from ALL observing KFs
        (outside-window observers anchor the gauge), (b) window KF pose <-
        Kabsch(world landmarks -> cam observations). Oldest window KF stays
        fixed. Returns the fids whose pose changed."""
        window = self._kf_order[-self.ba_window:]
        if len(window) < 2:
            return []
        wset = set(window)
        touched = [lm for lm in self.landmarks.values()
                   if any(f in wset for f in lm.obs)]
        # Flatten the observation graph ONCE (it is fixed across sweeps;
        # only poses and landmark positions move). The per-landmark /
        # per-observation Python loops this replaces were the system
        # loop's hottest host code: ~56k np.mean calls per keyframe at
        # bench scale (~400 ms of the 594 ms/frame track cost).
        fid_index: dict[int, int] = {}
        obs_lm, obs_kf, obs_cam = [], [], []
        for li, lm in enumerate(touched):
            for f, camp in lm.obs.items():
                if f in self.keyframes:
                    j = fid_index.setdefault(f, len(fid_index))
                    obs_lm.append(li)
                    obs_kf.append(j)
                    obs_cam.append(camp)
        if obs_lm:
            obs_lm = np.asarray(obs_lm)
            obs_kf = np.asarray(obs_kf)
            obs_cam = np.asarray(obs_cam, np.float32)
            inv = {v: k for k, v in fid_index.items()}
            kfl = [self.keyframes[inv[j]] for j in range(len(fid_index))]
            R_all = np.stack([k.R for k in kfl]).astype(np.float32)
            t_all = np.stack([k.t for k in kfl]).astype(np.float32)
            nl = len(touched)
            counts = np.maximum(np.bincount(obs_lm, minlength=nl), 1)
            win_rows = {f: np.flatnonzero(obs_kf == fid_index[f])
                        for f in window[1:] if f in fid_index}
            world = np.stack([lm.world for lm in touched]).astype(np.float32)
            for _ in range(self.ba_sweeps):
                # (a) landmark <- mean of backprojections from ALL live
                # observing KFs ((camp - t) @ R per observation)
                pts = np.einsum("mj,mjk->mk", obs_cam - t_all[obs_kf],
                                R_all[obs_kf])
                acc = np.zeros((nl, 3), np.float32)
                np.add.at(acc, obs_lm, pts)
                world = acc / counts[:, None].astype(np.float32)
                # (b) window KF pose <- Kabsch(world -> cam observations)
                for f in window[1:]:
                    rows = win_rows.get(f)
                    if rows is not None and len(rows) >= 6:
                        j = fid_index[f]
                        R_all[j], t_all[j] = rigid_align(
                            world[obs_lm[rows]], obs_cam[rows])
            for li, lm in enumerate(touched):
                lm.world = world[li]
            for f in window[1:]:
                j = fid_index.get(f)
                if j is not None:
                    k = self.keyframes[f]
                    k.R, k.t = R_all[j], t_all[j]
        # keep the live tracking pose consistent with the refined newest KF
        newest = self.keyframes[window[-1]]
        self._cur_R, self._cur_t = newest.R.copy(), newest.t.copy()
        return window[1:]

    # -- culling -----------------------------------------------------------
    def _cull_keyframes(self) -> None:
        """ORB-SLAM3 KeyFrameCulling rule, conservatively: a non-recent KF
        whose landmarks are >=cull_redundancy covered by >=4 other KFs is
        removed from the live set (the mapper's cull_keyframes drops it next
        drain). At most ONE cull per new keyframe (the reference also culls
        incrementally per LocalMapping pass) and the recent BA window plus
        the map origin are protected — aggressive culling would erase loop
        anchors and starve the mapper of views."""
        protected = set(self._kf_order[-max(self.ba_window, 3):])
        protected.add(self._kf_order[0])
        # ONE pass over landmarks builds per-KF (observed, redundant)
        # counters — the per-KF × per-landmark double loop was
        # O(KFs * landmarks * obs) per new keyframe, quadratic pain at
        # ScanNet scale. For each landmark: every live observer sees it;
        # an observer's "others" count is (live observers - 1), so the
        # landmark is redundant for ALL its observers iff live >= 5.
        n_obs: dict[int, int] = {}
        n_red: dict[int, int] = {}
        for lm in self.landmarks.values():
            obs_f = lm.obs if lm.obs else lm.obs2d
            live = [f for f in obs_f if f in self.keyframes]
            red = len(live) - 1 >= 4
            for f in live:
                n_obs[f] = n_obs.get(f, 0) + 1
                if red:
                    n_red[f] = n_red.get(f, 0) + 1
        for fid in list(self._kf_order):
            if fid in protected:
                continue
            no = n_obs.get(fid, 0)
            if no and n_red.get(fid, 0) / no >= self.cull_redundancy:
                self._remove_keyframe(fid)
                break  # one per pass
        if self.max_keyframes_live > 0:
            while len(self._kf_order) > self.max_keyframes_live:
                self._remove_keyframe(self._kf_order[1])
        # landmark GC: no live-KF observation and not actively tracked
        active = set(int(i) for i in self._track_lm)
        dead = [i for i, lm in self.landmarks.items()
                if i not in active and
                not any(f in self.keyframes for f in lm.obs) and
                not any(f in self.keyframes for f in lm.obs2d)]
        for i in dead:
            del self.landmarks[i]

    def _remove_keyframe(self, fid: int) -> None:
        self._kf_order.remove(fid)
        self._kf_pooled.pop(fid, None)
        self._kf_thumb.pop(fid, None)
        self._kf_desc.pop(fid, None)
        kf = self.keyframes.pop(fid, None)
        if kf is not None:  # freeze for trajectory reconstruction
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = kf.R, kf.t
            self._kf_final[fid] = T
        for lm in self.landmarks.values():
            lm.obs.pop(fid, None)
            lm.obs2d.pop(fid, None)
        self.queue.remove_keyframe(fid)

    # -- loop closing --------------------------------------------------
    def _try_loop_close(self, kf: _KF) -> None:
        """Appearance-first loop detection (drift makes a pose-proximity
        gate unreliable — ORB-SLAM3 uses DBoW2 for the same reason), Kabsch
        geometric verification against the loop keyframe's ORIGINAL map
        region, and a rigid world correction propagated to the recent
        window before local BA re-harmonizes it. Publishes a LOOP_CLOSE_BA
        op (LoopClosing.cc:1027-1034 push-site contract)."""
        if len(self._kf_order) <= self.loop_min_gap:
            return
        a = self._kf_pooled.get(kf.fid)
        if a is None:
            a = _pool_gray(kf.gray)
        c_now = -(kf.R.T @ kf.t)
        gated = []
        for old_fid in self._kf_order[:-self.loop_min_gap]:
            old = self.keyframes[old_fid]
            c_old = -(old.R.T @ old.t)
            # generous pose gate only to cut absurd candidates; drift-safe
            if np.linalg.norm(c_now - c_old) <= 6.0 * self.loop_radius:
                gated.append(old_fid)
        # candidate scoring: pooled peak-correlation (shift-invariant
        # global appearance) AND the descriptor shift-coherence place
        # score (_place_score) — peak_corr alone aliases on repeated
        # structure (near-identical rooms pool identically); descriptors
        # + coherent-shift voting discriminate local detail, the role
        # DBoW2 plays in the reference (LoopClosing.cc DetectLoop)
        qd, qp = self._kf_desc.get(kf.fid) or self._query_desc(kf.gray)
        best, best_fid = self.loop_desc_th, None
        for old_fid in self._shortlist(kf.gray, gated, 8):
            if _peak_corr(a, self._kf_pooled[old_fid]) <= \
                    self.loop_appearance_th:
                continue
            ent = self._kf_desc.get(old_fid)
            if ent is None:
                continue
            coh = _place_score(qd, qp, ent[0], ent[1])
            if coh > best:
                best, best_fid = coh, old_fid
        if best_fid is None:
            self._loop_pending = None
            return
        # temporal consistency (the reference's consistency groups,
        # LoopClosing.cc DetectLoop): the same anchor region must score
        # for `loop_consistency` consecutive keyframes before the
        # expensive geometric verification may accept — a single-KF
        # appearance fluke cannot close a loop
        a_ord = self._kf_order.index(best_fid)
        if self.loop_consistency > 1:
            if self._loop_pending is not None and \
                    abs(self._loop_pending[0] - a_ord) <= 2:
                self._loop_pending = (a_ord, self._loop_pending[1] + 1)
            else:
                self._loop_pending = (a_ord, 1)
            if self._loop_pending[1] < self.loop_consistency:
                return
        old = self.keyframes[best_fid]
        S_mc = None
        if self.sensor == "mono":
            # monocular verification has no depth to lift: track the
            # anchor's landmark pixels into this frame and PnP against
            # their anchor-era world points (3D-2D, like relocalization).
            # The loop edge itself is the relative Sim(3) S_mc estimated
            # by Horn on 3D-3D matches (the reference's ComputeSim3 /
            # Sim3Solver, LoopClosing.cc), so accumulated scale drift is
            # corrected by the essential-graph optimization below rather
            # than deferred to the depth-borrow ScaleRefinement path.
            pose = self._loop_verify_mono(old, kf)
            if pose is None:
                return
            R, t, S_mc = pose
        else:
            # geometric verification: track old-KF corners into this frame
            pts = detect_corners(old.gray, 300)
            cur_px, ok = klt_track(old.gray, kf.gray, pts)
            if ok.sum() < self.min_inliers:
                return
            cam_old, ok_o = self._lift(pts[ok], old.depth)
            cam_new, ok_n = self._lift(cur_px[ok], kf.depth)
            use = ok_o & ok_n
            if use.sum() < self.min_inliers:
                return
            world_old = self._to_world(cam_old[use], old.R, old.t)
            R, t, inl = ransac_rigid(world_old, cam_new[use], self._rng,
                                     thresh=self.ransac_thresh,
                                     min_inliers=self.min_inliers)
            if R is None or inl.sum() < 2 * self.min_inliers:
                return
        # world correction W: drifted world -> loop-consistent world, from
        # the current KF's drifted vs corrected pose. Drift accumulated
        # gradually since the loop anchor: distribute W along the KF chain
        # anchor->current with fractional screw interpolation as the
        # initial guess, then run the SE(3) pose-graph optimization
        # (slam/pose_graph.py) over the chain — the counterpart of the
        # reference's essential-graph optimization after loop verification
        # (Optimizer.cc OptimizeEssentialGraph via LoopClosing.cc):
        # odometry edges keep consecutive relative poses, a heavily
        # weighted loop edge ties the current KF to its Kabsch-verified
        # pose in the anchor's frame.
        T_drift = np.eye(4, dtype=np.float32)
        T_drift[:3, :3], T_drift[:3, 3] = kf.R, kf.t
        T_corr = np.eye(4, dtype=np.float32)
        T_corr[:3, :3], T_corr[:3, 3] = R, t
        W = np.linalg.inv(T_corr) @ T_drift
        a_idx = self._kf_order.index(best_fid)
        chain = self._kf_order[a_idx + 1:]
        if not chain:
            return
        chain_set = set(chain)
        from legslam_torch.slam import pose_graph as PG
        full = [best_fid] + chain               # anchor first, held fixed
        Tcw = []
        for f in full:
            k = self.keyframes[f]
            Tk = np.eye(4, dtype=np.float32)
            Tk[:3, :3], Tk[:3, 3] = k.R, k.t
            Tcw.append(Tk)
        P = np.stack([np.linalg.inv(Tk) for Tk in Tcw])   # Twc
        kf_scales: dict[int, float] = {}
        if self.sensor == "mono":
            kf_scales = self._sim3_chain_correct(chain, P, T_corr, S_mc)
        else:
            odo = PG.chain_constraints(P, weight=1.0)     # pre-correction
            loop_edge = (0, len(full) - 1,
                         np.linalg.inv(np.asarray(P[0], np.float64)) @
                         np.linalg.inv(np.asarray(T_corr, np.float64)),
                         100.0)
            for j, f in enumerate(chain):                 # screw init
                s = (j + 1) / len(chain)
                W_s = _fractional_rigid(W, s)
                P[j + 1] = np.linalg.inv(Tcw[j + 1] @ np.linalg.inv(W_s))
            P = PG.optimize_pose_graph(P, odo + [loop_edge], fixed={0})
            for j, f in enumerate(chain):
                Tk = np.linalg.inv(P[j + 1]).astype(np.float32)
                k = self.keyframes[f]
                k.R, k.t = np.ascontiguousarray(Tk[:3, :3]), \
                    np.ascontiguousarray(Tk[:3, 3])
        # re-triangulate landmarks touched by the chain from their
        # corrected observers (one landmark sweep of the BA alternation).
        # RGB-D landmarks carry 3D camera-frame obs; mono landmarks only
        # 2D normalized obs (obs2d) and re-triangulate by DLT like
        # _mono_local_ba does.
        for lm in self.landmarks.values():
            if lm.obs and any(f in chain_set for f in lm.obs):
                pts = [self._to_world(camp[None], self.keyframes[f].R,
                                      self.keyframes[f].t)[0]
                       for f, camp in lm.obs.items() if f in self.keyframes]
                if pts:
                    lm.world = np.mean(pts, axis=0).astype(np.float32)
            elif lm.world is not None and \
                    any(f in chain_set for f in lm.obs2d):
                fids = [f for f in lm.obs2d if f in self.keyframes]
                if len(fids) < 2:
                    continue
                Rs = np.stack([self.keyframes[f].R for f in fids])
                ts = np.stack([self.keyframes[f].t for f in fids])
                xs = np.stack([lm.obs2d[f] for f in fids])
                X = triangulate_multi(Rs, ts, xs)
                if X is not None and np.isfinite(X).all():
                    cams = np.einsum("kij,j->ki", Rs, X) + ts
                    if np.all(cams[:, 2] > 1e-3):
                        lm.world = X
        self._cur_R, self._cur_t = kf.R.copy(), kf.t.copy()
        self._store_pose(kf.fid)
        self._local_ba()
        packets = [self._pose_packet(f)
                   for f in chain[-self.ba_window:]]
        for p in packets:
            p.is_loop_kf = True
            # per-KF Sim(3) scale from the essential graph: the mapper's
            # visible-point surgery scales the gaussians anchored to this
            # keyframe by it (mono loops; 1.0 for rgbd/stereo)
            p.scale = kf_scales.get(p.fid, 1.0)
        self.queue.push(MappingOperation(
            kind=OpKind.LOOP_CLOSE_BA, keyframes=packets))
        self.n_loop_closures += 1
        self._loop_pending = None

    def _sim3_chain_correct(self, chain: list, P: np.ndarray,
                            T_corr: np.ndarray,
                            S_mc: Optional[np.ndarray]) -> dict:
        """Monocular essential-graph correction: optimize the anchor->
        current keyframe chain over Sim(3) vertices (Optimizer.cc
        OptimizeEssentialGraph with bFixScale=false via LoopClosing.cc
        CorrectLoop) so scale drift accumulated along the chain is
        distributed by the per-vertex scale DoF. P is [1+len(chain),4,4]
        drifted Twc with the anchor first; the loop edge is the Horn
        Sim(3) S_mc when available, else the PnP SE(3) at scale 1.
        Writes corrected SE(3) poses back to the keyframes (a Sim(3)
        camera [sR|t] acts on world points identically to its SE(3)
        part — scale only matters for correcting anchored structure)
        and returns {fid: scale} for the mapper's point surgery."""
        from legslam_torch.slam import pose_graph as PG
        P64 = np.asarray(P, np.float64)
        odo = PG.chain_constraints(P64, weight=1.0)       # pre-correction
        if S_mc is None:
            M_loop = np.linalg.inv(P64[0]) @ \
                np.linalg.inv(np.asarray(T_corr, np.float64))
        else:
            M_loop = np.asarray(S_mc, np.float64)
        loop_edge = (0, len(P64) - 1, M_loop, 100.0)
        # geodesic-fractional Sim(3) init: distribute the world correction
        # W = S_cur_corrected @ Twc_drift^-1 along the chain
        W = (P64[0] @ M_loop) @ np.linalg.inv(P64[-1])
        xi_w = PG.sim3_log(W)
        Pi = P64.copy()
        for j in range(len(chain)):
            frac = (j + 1) / len(chain)
            Pi[j + 1] = PG.sim3_exp(frac * xi_w) @ P64[j + 1]
        Popt = PG.optimize_sim3_graph(Pi, odo + [loop_edge], fixed={0})
        scales: dict[int, float] = {}
        for j, f in enumerate(chain):
            R_wc, t_wc, s = PG.sim3_parts(Popt[j + 1])
            Twc = np.eye(4)
            Twc[:3, :3], Twc[:3, 3] = R_wc, t_wc
            Tk = np.linalg.inv(Twc).astype(np.float32)
            k = self.keyframes[f]
            k.R, k.t = np.ascontiguousarray(Tk[:3, :3]), \
                np.ascontiguousarray(Tk[:3, 3])
            scales[f] = float(s)
        return scales

    def _loop_sim3_mono(self, old: _KF, kf: _KF, px_cur: np.ndarray,
                        world_anchor: np.ndarray, R_corr: np.ndarray,
                        t_corr: np.ndarray) -> Optional[np.ndarray]:
        """Estimate the mono loop's relative Sim(3) S_mc (current-cam ->
        anchor-cam, the reference's Sim3Solver/ComputeSim3 analogue):
        anchor-era camera points come from the verified matches' landmark
        worlds; their DRIFTED-scale current-camera points from two-view
        triangulation against the previous keyframe at the still-drifted
        poses. Horn on the 3D-3D pairs yields (R, t, s); the rotation is
        gated against the PnP estimate. Returns [[sR, t],[0,1]] or None
        (the caller then falls back to a scale-1 loop edge)."""
        if len(self._kf_order) < 2:
            return None
        prev = self.keyframes.get(self._kf_order[-2])
        if prev is None or prev.fid == old.fid or prev.fid == kf.fid:
            return None
        px_prev, ok = klt_track_fb(kf.gray, prev.gray, px_cur)
        if int(ok.sum()) < self.min_inliers:
            return None
        xn_cur = self._normalize(px_cur[ok])
        xn_prev = self._normalize(px_prev[ok])
        wa = world_anchor[ok]
        Rs = np.stack([kf.R, prev.R])
        ts = np.stack([kf.t, prev.t])
        x_c, x_m = [], []
        for i in range(xn_cur.shape[0]):
            X = triangulate_multi(Rs, ts,
                                  np.stack([xn_cur[i], xn_prev[i]]))
            if X is None or not np.isfinite(X).all():
                continue
            cams = Rs @ X + ts                            # [2,3]
            if not np.all(cams[:, 2] > 1e-3):
                continue
            if np.linalg.norm(cams[0, :2] / cams[0, 2] - xn_cur[i]) > 8e-3:
                continue
            x_c.append(cams[0])
            x_m.append(old.R @ wa[i] + old.t)
        if len(x_c) < max(self.min_inliers, 8):
            return None
        x_c, x_m = np.stack(x_c), np.stack(x_m)
        from legslam_torch.slam import pose_graph as PG
        R_u, t_u, s = PG.umeyama_sim3(x_c, x_m)
        # one trimmed re-fit: drop correspondences past 2.5x the median
        # residual (triangulation against one nearby KF is parallax-noisy)
        res = np.linalg.norm(x_m - (s * (x_c @ R_u.T) + t_u), axis=1)
        keep = res <= 2.5 * max(float(np.median(res)), 1e-9)
        if int(keep.sum()) >= max(self.min_inliers, 8):
            R_u, t_u, s = PG.umeyama_sim3(x_c[keep], x_m[keep])
        # gates: Horn rotation must agree with the (more robust, many-
        # point) PnP loop pose; scale within a sane drift envelope
        R_mc = old.R @ R_corr.T
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(R_u @ R_mc.T) - 1.0) / 2.0, -1.0, 1.0)))
        if not (0.2 < s < 5.0) or ang > 15.0:
            return None
        return PG.sim3_matrix(R_u, t_u, s)

    def _loop_verify_mono(self, old: _KF, kf: _KF
                          ) -> Optional[tuple]:
        """Mono loop verification: KLT the anchor keyframe's landmark
        pixels into the current frame, PnP against their (anchor-era,
        loop-consistent) world points. Returns the corrected current
        (R, t, S_mc) — S_mc the relative Sim(3) loop edge from
        _loop_sim3_mono, or None when its gates fail — or None when
        verification fails. Does not touch live track state."""
        px_old, world = [], []
        for lm in self.landmarks.values():
            if lm.world is not None and old.fid in lm.obs2d:
                px_old.append(lm.obs2d[old.fid])
                world.append(lm.world)
        if len(px_old) < 2 * self.min_inliers:
            return None
        px_old = self._denormalize(np.asarray(px_old, np.float32))
        world = np.asarray(world, np.float32)
        cur_px, ok = klt_track_fb(old.gray, kf.gray, px_old)
        if ok.sum() < self.min_inliers:
            return None
        xn = self._normalize(cur_px[ok])
        # init at the ANCHOR pose (the camera is physically near it at
        # loop time; the drifted current pose may be a wrong GN basin).
        # Looser huber/inlier gates than frame-to-frame PnP: loop-scale
        # KLT carries a few px of localization noise on top of the
        # landmarks' triangulation noise — the pose-graph + local BA
        # refine whatever this accepts.
        R, t, inl = pnp_gn(world[ok], xn, old.R, old.t,
                           huber=2e-2, inlier_th=4e-2)
        if R is None or inl.sum() < self.min_inliers or \
                inl.sum() < 0.5 * int(ok.sum()):
            return None
        S_mc = self._loop_sim3_mono(old, kf, cur_px[ok][inl],
                                    world[ok][inl], R, t)
        return R, t, S_mc

    # -- trajectory / lifecycle -----------------------------------------
    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_ids [N], c2w [N,4,4]) for every processed frame, each
        reconstructed from its reference keyframe's CURRENT (BA / loop-
        corrected) pose so late corrections retro-apply to the history."""
        fids = np.asarray(sorted(self.poses), np.int64)
        out = []
        for f in fids:
            f = int(f)
            ref = self._frame_ref.get(f)
            if ref is not None:
                ref_fid, T_rel = ref
                kf = self.keyframes.get(ref_fid)
                if kf is not None:
                    T_kf = np.eye(4, dtype=np.float32)
                    T_kf[:3, :3], T_kf[:3, 3] = kf.R, kf.t
                elif ref_fid in self._kf_final:
                    T_kf = self._kf_final[ref_fid]
                else:
                    out.append(self.poses[f])
                    continue
                out.append(np.linalg.inv(T_rel @ T_kf).astype(np.float32))
            else:
                out.append(self.poses[f])
        return fids, np.stack(out)

    def finish(self) -> None:
        self.queue.shutdown()

    @property
    def num_keyframes(self) -> int:
        return len(self._kf_order)


def _fractional_rigid(T: np.ndarray, s: float) -> np.ndarray:
    """Fractional rigid transform: rotation scaled on its axis-angle,
    translation scaled linearly (first-order screw interpolation)."""
    R = T[:3, :3]
    cos_a = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.arccos(cos_a)
    if ang < 1e-8:
        Rs = np.eye(3, dtype=np.float32)
    else:
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / (2.0 * np.sin(ang))
        a = s * ang
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]], np.float32)
        Rs = np.eye(3, dtype=np.float32) + np.sin(a) * K + \
            (1 - np.cos(a)) * (K @ K)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rs
    out[:3, 3] = s * T[:3, 3]
    return out


def _pool_gray(gray: np.ndarray, f: int = 4) -> np.ndarray:
    """Box-pooled zero-mean float image (loop-descriptor preprocessing)."""
    h, w = gray.shape
    g = gray[:h // f * f, :w // f * f].astype(np.float32)
    g = g.reshape(h // f, f, w // f, f).mean((1, 3))
    return g - g.mean()


def _thumb(gray: np.ndarray, cells: int = 16) -> np.ndarray:
    """Flattened zero-mean unit-norm block-mean thumbnail [cells*cells].
    The vectorized candidate prefilter: one [K, 256] @ [256] product ranks
    the whole keyframe store; coarse cells tolerate the image-space shifts
    the FFT stage resolves exactly."""
    h, w = gray.shape
    fy, fx = max(h // cells, 1), max(w // cells, 1)
    ny, nx = h // fy, w // fx
    g = gray[:ny * fy, :nx * fx].astype(np.float32)
    g = g.reshape(ny, fy, nx, fx).mean((1, 3))
    g = g[:cells, :cells]
    if g.shape != (cells, cells):   # tiny images: pad with the mean
        out = np.full((cells, cells), float(g.mean()), np.float32)
        out[:g.shape[0], :g.shape[1]] = g
        g = out
    v = (g - g.mean()).reshape(-1)
    return v / (np.linalg.norm(v) + 1e-9)


def _peak_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Max normalized cross-correlation over 2D shifts (FFT). Used as the
    loop-closure appearance score: in-place revisits differ mostly by an
    image-space shift, which plain ZNCC cannot absorb (the reference uses
    DBoW2 bag-of-words for the same shift/viewpoint invariance)."""
    A = np.fft.rfft2(a)
    B = np.fft.rfft2(b)
    cc = np.fft.irfft2(A * np.conj(B), s=a.shape)
    return float(cc.max() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-6))


def _patch_descriptors(gray: np.ndarray, px: np.ndarray, patch: int = 16,
                       out: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Zero-mean unit-norm mean-pooled patch descriptors at keypoints.

    ([M, out*out] f32, kept [M, 2] pixel coords). Border keypoints whose
    patch falls outside the image and near-flat patches are dropped.
    The local-detail half of the place-recognition score — the
    counterpart of ORB descriptors feeding DBoW2 in the reference
    (ORB-SLAM3 KeyFrame::ComputeBoW)."""
    h, w = gray.shape
    px = np.asarray(px, np.float32).reshape(-1, 2)
    r = patch // 2
    xs = np.round(px[:, 0]).astype(np.int64)
    ys = np.round(px[:, 1]).astype(np.int64)
    ok = (xs >= r) & (ys >= r) & (xs <= w - r) & (ys <= h - r)
    xs, ys = xs[ok], ys[ok]
    if not len(xs):
        return (np.zeros((0, out * out), np.float32),
                np.zeros((0, 2), np.float32))
    dy = np.arange(-r, r)
    g = gray.astype(np.float32)
    # [M, patch, patch] gather, pooled to [M, out, out]
    p = g[(ys[:, None, None] + dy[None, :, None]),
          (xs[:, None, None] + dy[None, None, :])]
    f = patch // out
    p = p.reshape(-1, out, f, out, f).mean((2, 4))
    v = p.reshape(-1, out * out)
    v = v - v.mean(axis=1, keepdims=True)
    n = np.linalg.norm(v, axis=1)
    keep = n > 1e-3
    v = v[keep] / n[keep, None]
    return v.astype(np.float32), px[ok][keep]


def _place_score(desc_q: np.ndarray, px_q: np.ndarray,
                 desc_c: np.ndarray, px_c: np.ndarray,
                 cos_th: float = 0.85, ratio: float = 0.9,
                 bin_px: int = 12) -> float:
    """Descriptor-based place-recognition score in [0, 1]: fraction of
    query keypoints whose mutual-best ratio-tested descriptor match agrees
    with the dominant 2D shift (coarse-bin voting with half-bin offsets).

    Shift-coherence is the weak geometric verification: an in-place
    revisit (even drift-shifted) produces one dominant shift cluster,
    while a perceptually-aliased different place yields matches with
    incoherent shifts. Measured on synthetic aliased rooms (locally
    color-shuffled clone of the same geometry): true revisit ~0.2 vs
    aliased ~0.08 at the loop operating point — the discrimination
    pooled peak-correlation lacks (clone peak_corr 0.47 vs true 0.51).

    Rotation/viewpoint recall bound (pinned in
    tests/test_place_recognition.py::test_rotated_revisit_refuses_safely):
    the raw patches are NOT rotation-normalized (unlike ORB feeding DBoW2
    in the reference) and the vote models a revisit as a 2D translation,
    so recall extends to ~5 deg of in-plane rotation (score 0.19 vs the
    0.12 threshold on the orbit fixture) and REFUSES beyond (~0.02 at
    >= 15 deg, with the pooled-correlation gate independently rejecting
    too). The failure mode is a missed loop, never a false one."""
    if len(desc_q) < 8 or len(desc_c) < 8:
        return 0.0
    S = desc_q @ desc_c.T
    j = np.argmax(S, axis=1)
    best = S[np.arange(len(desc_q)), j]
    i_back = np.argmax(S, axis=0)
    mutual = i_back[j] == np.arange(len(desc_q))
    second = -np.partition(-S, 1, axis=1)[:, 1]
    d1 = np.sqrt(np.maximum(2.0 - 2.0 * best, 0.0))
    d2 = np.sqrt(np.maximum(2.0 - 2.0 * second, 1e-12))
    good = (best > cos_th) & mutual & (d1 < ratio * d2)
    if good.sum() < 4:
        return 0.0
    shifts = px_q[good] - px_c[j[good]]
    bins = np.round(shifts / bin_px).astype(np.int64)
    # vote each match into its bin and the 3 neighbors (half-bin offsets)
    # so a cluster straddling a bin edge still concentrates
    cands = np.concatenate([bins + d for d in
                            ([0, 0], [0, 1], [1, 0], [1, 1])])
    _, counts = np.unique(cands, axis=0, return_counts=True)
    return float(counts.max()) / max(len(desc_q), 1)
