"""SE(3) and Sim(3) pose-graph optimization for loop closure.

A copy of legslam_tpu/slam/pose_graph.py: host numpy in float64, the
same code in the same order, so the two give identical results.

The tracking frontend's counterpart of ORB-SLAM3's essential-graph optimization
(reference: ORB-SLAM3/src/Optimizer.cc OptimizeEssentialGraph, invoked by
LoopClosing.cc after a loop is verified): keyframe poses along the
anchor->current chain are refined so that (a) consecutive relative poses
stay near their odometry estimates and (b) the loop constraint between the
anchor region and the current keyframe is satisfied. Where the reference
runs g2o Levenberg-Marquardt over Sim3 vertices, this runs a dense
Gauss-Newton over right-perturbations in numpy — chains are a few
hundred keyframes at most, so the banded normal equations are trivial on
the host (the hot path stays on the device; this is episodic CPU work like
the rest of the tracking frontend). Two vertex groups are provided:
SE(3) (`optimize_pose_graph`, used for rgbd/stereo loops where depth
pins the scale) and Sim(3) (`optimize_sim3_graph`, used for monocular
loops where scale drifts along the chain — the reference's
OptimizeEssentialGraph always optimizes Sim3 vertices and fixes scale=1
for non-mono sensors, Optimizer.cc).

Conventions: poses are camera-to-world 4x4 (P = Twc); Sim(3) elements
are 4x4 [[s*R, t], [0, 1]] so composition/inverse are plain matmul /
np.linalg.inv. A constraint (i, j, M, w) says P_i^-1 @ P_j should equal
M, weighted w. Residual r = log(M^-1 (P_i^-1 P_j)) in the group algebra;
Jacobians use the g2o-style converged-residual linearization
(d r/d delta_j = I, d r/d delta_i = -Ad(P_j^-1 P_i)).
"""
from __future__ import annotations

import numpy as np


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]], dtype=np.float64)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """xi = (omega, v) -> 4x4 via the closed-form SE(3) exponential."""
    w, v = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-4:
        # series to O(th^3); the closed form's 1-cos/1-sinc underflow to
        # exactly 0 below th ~ 3e-8 (see se3_log)
        R = np.eye(3) + W + 0.5 * (W @ W)
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        A = np.sin(th) / th
        B = (1.0 - np.cos(th)) / (th * th)
        C = (1.0 - A) / (th * th)
        R = np.eye(3) + A * W + B * (W @ W)
        V = np.eye(3) + B * W + C * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def _so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation log, safe across the whole range including theta ~ pi
    (where the sin-based axis extraction degenerates)."""
    R = np.asarray(R, np.float64)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) * 0.5
    if th > np.pi - 1e-4:
        # near pi: (R + I)/2 ~ a a^T + cos-term; take the axis from the
        # largest diagonal of (M - c I)/(1 - c), sign from the skew part
        # R_sym = c I + (1-c) a a^T  =>  a a^T = (M - c I)/(1 - c)
        M = 0.5 * (R + R.T)
        aa = np.clip(np.diag(M) - c, 0.0, None) / (1.0 - c)
        k = int(np.argmax(aa))
        a = np.empty(3)
        a[k] = np.sqrt(max(aa[k], 1e-16))
        for m in range(3):
            if m != k:
                a[m] = M[k, m] / ((1.0 - c) * a[k])
        a /= max(np.linalg.norm(a), 1e-12)
        skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
        if float(skew @ a) < 0.0:
            a = -a
        return th * a
    return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) * (th / (2.0 * np.sin(th)))


def se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 -> (omega, v)."""
    t = np.asarray(T[:3, 3], np.float64)
    w = _so3_log(T[:3, :3])
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-4:
        # series: V^-1 = I - W/2 + W^2/12 + O(th^4). The closed form
        # below is NOT safe here: 1 - cos(th) underflows to exactly 0
        # for th < ~1.5e-8 (f64), making B = 0 and coef = inf — NaN
        # translations on near-pure-translation edges (the common
        # consecutive-keyframe odometry case).
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
        return np.concatenate([w, Vinv @ t])
    # V^-1 = I - W/2 + (1 - A/(2B)) / th^2 * W^2 with A = sin(th)/th,
    # B = (1-cos th)/th^2 — finite at th = pi (limit 1/pi^2)
    A = np.sin(th) / th
    B = (1.0 - np.cos(th)) / (th * th)
    coef = (1.0 - A / (2.0 * B)) / (th * th)
    Vinv = np.eye(3) - 0.5 * W + coef * (W @ W)
    return np.concatenate([w, Vinv @ t])


def _adjoint(T: np.ndarray) -> np.ndarray:
    """6x6 SE(3) adjoint for the (omega, v) twist ordering."""
    R = np.asarray(T[:3, :3], np.float64)
    t = np.asarray(T[:3, 3], np.float64)
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, 3:] = R
    A[3:, :3] = _hat(t) @ R
    return A


# -- Sim(3) ------------------------------------------------------------
# Element representation: 4x4 [[s*R, t], [0, 1]]; tangent ordering
# (omega[3], v[3], sigma) with s = exp(sigma). The algebra element is
# [[sigma*I + hat(omega), v], [0, 0]] and the group exp is its plain
# matrix exponential, so exp/log lean on scipy's expm for the
# translation-coupling integral W = int_0^1 exp(u*(sigma*I + Omega)) du
# instead of the branch-heavy closed-form series (episodic host code;
# exactness over speed).


def sim3_matrix(R: np.ndarray, t: np.ndarray, s: float) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = float(s) * np.asarray(R, np.float64)
    T[:3, 3] = np.asarray(t, np.float64)
    return T


def sim3_parts(T: np.ndarray) -> tuple:
    """4x4 [[sR, t],[0,1]] -> (R, t, s)."""
    sR = np.asarray(T[:3, :3], np.float64)
    s = float(np.cbrt(np.linalg.det(sR)))
    return sR / s, np.asarray(T[:3, 3], np.float64).copy(), s


def _sim3_W(omega: np.ndarray, sigma: float) -> np.ndarray:
    """W with t = W v in the Sim(3) exponential: the top-right block of
    expm([[sigma*I + Omega, I], [0, 0]]) (block-triangular identity
    exp([[A, B],[0,0]]) = [[e^A, (int_0^1 e^{uA} du) B],[0, I]])."""
    from scipy.linalg import expm
    M = np.zeros((6, 6))
    M[:3, :3] = sigma * np.eye(3) + _hat(omega)
    M[:3, 3:] = np.eye(3)
    return expm(M)[:3, 3:]


def sim3_exp(xi: np.ndarray) -> np.ndarray:
    """(omega, v, sigma) -> 4x4 [[sR, Wv],[0,1]]."""
    from scipy.linalg import expm
    xi = np.asarray(xi, np.float64)
    M = np.zeros((4, 4))
    M[:3, :3] = xi[6] * np.eye(3) + _hat(xi[:3])
    M[:3, 3] = xi[3:6]
    return expm(M)


def sim3_log(T: np.ndarray) -> np.ndarray:
    """4x4 -> (omega, v, sigma). W is invertible for |omega| <= pi
    unless sigma = 0 and theta = 2*pi*k, which _so3_log never emits."""
    R, t, s = sim3_parts(T)
    w = _so3_log(R)
    sigma = float(np.log(s))
    v = np.linalg.solve(_sim3_W(w, sigma), t)
    return np.concatenate([w, v, [sigma]])


def _sim3_adjoint(T: np.ndarray) -> np.ndarray:
    """7x7 Sim(3) adjoint for the (omega, v, sigma) ordering:
    log(T exp(xi) T^-1) = Ad_T xi with omega' = R w,
    v' = hat(t) R w + s R v - sigma t, sigma' = sigma."""
    R, t, s = sim3_parts(T)
    A = np.zeros((7, 7))
    A[:3, :3] = R
    A[3:6, :3] = _hat(t) @ R
    A[3:6, 3:6] = s * R
    A[3:6, 6] = -t
    A[6, 6] = 1.0
    return A


def _solve_normal(H: np.ndarray, b: np.ndarray, constraints: list,
                  col: dict, d: int = 6) -> np.ndarray:
    """Solve the GN normal equations. Loop-closure graphs are a keyframe
    CHAIN plus edges into the fixed anchor, so H is block-tridiagonal
    (half-bandwidth 2d-1 scalars) — solve it banded in O(K) instead of
    the dense O(K^3), which stalls the online tracking thread seconds per
    loop closure on long chains. Any edge that couples two free poses
    more than one chain step apart breaks the band; fall back to dense.
    """
    n = H.shape[0]
    banded = all(
        abs(col[i] - col[j]) <= d
        for (i, j, _, _) in constraints if i in col and j in col)
    if not banded or n <= 6 * d:
        return np.linalg.solve(H, b)
    from scipy.linalg import solve_banded
    lo = hi = 2 * d - 1
    ab = np.zeros((lo + hi + 1, n))
    for off in range(-lo, hi + 1):
        diag = np.diagonal(H, offset=off)
        ab[hi - off, max(off, 0):max(off, 0) + diag.shape[0]] = diag
    return solve_banded((lo, hi), ab, b)


def _optimize(poses, constraints, fixed, iters, damping,
              d, expf, logf, adjf) -> np.ndarray:
    """Gauss-Newton over a matrix Lie group with d-dim tangent.

    poses: [K, 4, 4] initial estimates (group elements).
    constraints: list of (i, j, M [4,4], weight) with M ~ P_i^-1 P_j.
    fixed: pose indices held constant (gauge anchor).
    Returns optimized [K, 4, 4]; falls back to the inputs if the solve
    goes non-finite (degenerate graph / near-pi pathologies).

    Jacobians use the standard small-residual right-perturbation
    linearization (Jr^{-1}(r) ~ I): d r / d delta_j = I,
    d r / d delta_i = -Ad(P_j^-1 P_i) — the g2o-style approximation,
    exact in the limit of converged residuals.
    """
    P0 = np.stack([np.asarray(p, np.float64) for p in poses])
    P = [p.copy() for p in P0]
    K = len(P)
    free = [k for k in range(K) if k not in fixed]
    col = {k: d * n for n, k in enumerate(free)}
    n_var = d * len(free)
    if n_var == 0 or not constraints:
        return P0.astype(np.float32)
    Minvs = [np.linalg.inv(np.asarray(M, np.float64))
             for (_, _, M, _) in constraints]
    Id = np.eye(d)

    for _ in range(iters):
        H = np.zeros((n_var, n_var))
        b = np.zeros(n_var)
        for (ci, (i, j, _, w)) in enumerate(constraints):
            r = logf(Minvs[ci] @ (np.linalg.inv(P[i]) @ P[j]))
            if not np.isfinite(r).all():
                continue
            blocks = {}
            if j in col:
                blocks[j] = Id
            if i in col:
                blocks[i] = -adjf(np.linalg.inv(P[j]) @ P[i])
            for k1, J1 in blocks.items():
                c1 = col[k1]
                b[c1:c1 + d] -= w * (J1.T @ r)
                for k2, J2 in blocks.items():
                    c2 = col[k2]
                    H[c1:c1 + d, c2:c2 + d] += w * (J1.T @ J2)
        H[np.diag_indices_from(H)] += damping * (1.0 + np.diag(H))
        try:
            delta = _solve_normal(H, b, constraints, col, d)
        except np.linalg.LinAlgError:
            break
        if not np.isfinite(delta).all():
            break
        for k in free:
            c = col[k]
            P[k] = P[k] @ expf(delta[c:c + d])
        if float(np.abs(delta).max()) < 1e-9:
            break
    out = np.stack(P)
    if not np.isfinite(out).all():
        return P0.astype(np.float32)
    return out.astype(np.float32)


def optimize_pose_graph(poses: np.ndarray,
                        constraints: list,
                        fixed: set | frozenset = frozenset({0}),
                        iters: int = 8,
                        damping: float = 1e-8) -> np.ndarray:
    """Gauss-Newton over SE(3) poses (see _optimize)."""
    return _optimize(poses, constraints, fixed, iters, damping,
                     6, se3_exp, se3_log, _adjoint)


def optimize_sim3_graph(poses: np.ndarray,
                        constraints: list,
                        fixed: set | frozenset = frozenset({0}),
                        iters: int = 10,
                        damping: float = 1e-8) -> np.ndarray:
    """Gauss-Newton over Sim(3) vertices — the monocular essential graph
    (Optimizer.cc OptimizeEssentialGraph with bFixScale=false): scale
    drift accumulated along the chain is distributed by the per-vertex
    sigma DoF instead of being absorbed into a single global rescale.
    poses/constraints are 4x4 [[sR, t],[0,1]] Sim(3) matrices."""
    return _optimize(poses, constraints, fixed, iters, damping,
                     7, sim3_exp, sim3_log, _sim3_adjoint)


def chain_constraints(poses: np.ndarray, weight: float = 1.0) -> list:
    """Odometry constraints between consecutive poses from their current
    estimates (the essential graph's spanning-tree edges)."""
    out = []
    for k in range(len(poses) - 1):
        M = np.linalg.inv(np.asarray(poses[k], np.float64)) @ \
            np.asarray(poses[k + 1], np.float64)
        out.append((k, k + 1, M, weight))
    return out


def umeyama_sim3(src: np.ndarray, dst: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, float]:
    """Closed-form similarity from 3D-3D correspondences: (R, t, s) with
    dst ~= s * R @ src + t (Horn / Umeyama 1991 — the solver behind
    ORB-SLAM3's Sim3Solver, used here to estimate the monocular loop
    edge's relative Sim(3) from matched anchor-era vs drifted-era camera
    points). src/dst are [N,3]."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = float((xs * xs).sum() / src.shape[0])
    s = float((D * np.diag(S)).sum() / max(var_s, 1e-12))
    t = mu_d - s * (R @ mu_s)
    return R, t, s
