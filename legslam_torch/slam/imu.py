"""IMU preintegration + visual-inertial helpers for the tracking frontend.

A copy of legslam_tpu/slam/imu.py (host numpy, float64).

Counterpart of the reference's inertial stack (C17 in SURVEY.md
§2): ORB-SLAM3's `IMU::Preintegrated` (ORB-SLAM3/src/ImuTypes.cc,
`IntegrateNewMeasurement`), the gravity/scale inertial initialization
(`ORB-SLAM3/src/LocalMapping.cc` InitializeIMU / ScaleRefinement — the
SCALE_REFINEMENT push sites at LocalMapping.cc:1300-1304,1501-1505), and
the IMU pose prediction used by `Tracking::PredictStateIMU`.

Redesigned, not ported: preintegration follows the standard on-manifold
formulation (Forster et al., "IMU Preintegration on Manifold", RSS 2015 —
public method); the mono-inertial scale+gravity initializer is a single
closed-form linear least squares over per-keyframe velocities, gravity,
and scale (the VINS-Mono-style linear alignment) instead of g2o factor
graphs. All of it is small per-frame CPU work in numpy, like the rest of
the frontend; the device stays dedicated to the mapper.

Frame conventions: body frame == camera frame unless a T_bc extrinsic is
given (EuRoC provides one). Gyro in rad/s, accel in m/s^2 *including* the
gravity reaction (an accelerometer at rest reads -g in body frame).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

GRAVITY = 9.81


def hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]], np.float64)


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues exponential map (axis-angle [3] -> rotation [3,3])."""
    ang = float(np.linalg.norm(w))
    if ang < 1e-12:
        return np.eye(3) + hat(w)     # first order (keeps tiny steps exact
        #                               to the integrator's order)
    K = hat(w / ang)
    return np.eye(3) + np.sin(ang) * K + (1.0 - np.cos(ang)) * (K @ K)


def log_so3(R: np.ndarray) -> np.ndarray:
    """Inverse of exp_so3 ([3,3] -> axis-angle [3])."""
    cos_a = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    ang = float(np.arccos(cos_a))
    if ang < 1e-12:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) * 0.5
    return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) * (ang / (2.0 * np.sin(ang)))


@dataclasses.dataclass
class Preintegrated:
    """Bias-corrected IMU deltas over an interval (body frame at start):
    R_end = R_start @ dR;  v_end = v + g*dt + R_start @ dv;
    p_end = p + v*dt + 0.5*g*dt^2 + R_start @ dp.
    (IMU::Preintegrated's GetDeltaRotation/Velocity/Position contract.)"""
    dR: np.ndarray         # [3,3]
    dv: np.ndarray         # [3]
    dp: np.ndarray         # [3]
    dt: float
    n: int                 # number of samples integrated

    @staticmethod
    def identity() -> "Preintegrated":
        return Preintegrated(np.eye(3), np.zeros(3), np.zeros(3), 0.0, 0)

    def merge(self, other: "Preintegrated") -> "Preintegrated":
        """Compose two consecutive preintegrations (MergePrevious)."""
        return Preintegrated(
            dR=self.dR @ other.dR,
            dv=self.dv + self.dR @ other.dv,
            dp=self.dp + self.dv * other.dt + self.dR @ other.dp,
            dt=self.dt + other.dt, n=self.n + other.n)


def preintegrate(samples: np.ndarray,
                 bias_g: Optional[np.ndarray] = None,
                 bias_a: Optional[np.ndarray] = None) -> Preintegrated:
    """Integrate IMU rows [K, 7] = (t, wx, wy, wz, ax, ay, az), timestamps
    ascending; each row's (w, a) is held over [t_k, t_{k+1}] and the last
    row only terminates the interval (K >= 2 rows integrate K-1 steps) —
    the zero-order-hold matching `IMU::Preintegrated::IntegrateNewMeasure-
    ment` (ORB-SLAM3/src/ImuTypes.cc)."""
    bg = np.zeros(3) if bias_g is None else np.asarray(bias_g, np.float64)
    ba = np.zeros(3) if bias_a is None else np.asarray(bias_a, np.float64)
    out = Preintegrated.identity()
    s = np.asarray(samples, np.float64)
    if s.ndim != 2 or s.shape[0] < 2:
        return out
    dR = np.eye(3)
    dv = np.zeros(3)
    dp = np.zeros(3)
    T = 0.0
    for k in range(s.shape[0] - 1):
        dt = float(s[k + 1, 0] - s[k, 0])
        if dt <= 0:
            continue
        w = s[k, 1:4] - bg
        a = s[k, 4:7] - ba
        acc = dR @ a
        dp = dp + dv * dt + 0.5 * acc * dt * dt
        dv = dv + acc * dt
        dR = dR @ exp_so3(w * dt)
        T += dt
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=T, n=s.shape[0] - 1)


def predict_pose(R_wb: np.ndarray, p_wb: np.ndarray, v_w: np.ndarray,
                 g_w: np.ndarray, pre: Preintegrated
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Propagate a world-frame state through a preintegrated delta
    (Tracking::PredictStateIMU). Returns (R_wb', p_wb', v_w')."""
    dt = pre.dt
    R2 = R_wb @ pre.dR
    p2 = p_wb + v_w * dt + 0.5 * g_w * dt * dt + R_wb @ pre.dp
    v2 = v_w + g_w * dt + R_wb @ pre.dv
    return R2, p2, v2


# ---------------------------------------------------------------------------
# Visual-inertial alignment (the inertial initialization)
# ---------------------------------------------------------------------------

def align_visual_inertial(R_wb: list, p_vis: list, pres: list,
                          gravity_mag: float = GRAVITY,
                          estimate_scale: bool = True
                          ) -> Optional[dict]:
    """Closed-form scale + gravity + per-KF velocity from keyframe visual
    poses and the preintegrated IMU between them.

    Args: R_wb[k] world->? no — BODY-to-world rotations [3,3] at KF k;
    p_vis[k] the (possibly unscaled, monocular) visual positions [3];
    pres[k] the Preintegrated delta KF k -> KF k+1 (len = K-1).

    Solves, for all k, the preintegration constraints
        s*dp_vis_k = v_k*dt + 0.5*g*dt^2 + R_k@dp_k
        dv_w_k     = v_{k+1} - v_k = g*dt + R_k@dv_k
    as one linear system in x = [v_0..v_{K-1}, g, s] (3K+4 unknowns,
    6(K-1) equations), then projects g to `gravity_mag`. The linear
    sub-problem is the public VINS-Mono initialization structure
    (solveGravityVector/LinearAlignment); the reference reaches the same
    quantities via g2o (LocalMapping::InitializeIMU).

    Returns dict(scale, g_w [3], v_w [K,3], residual) or None when the
    system is degenerate (insufficient excitation)."""
    K = len(R_wb)
    if K < 3 or len(pres) != K - 1:
        return None
    ns = 1 if estimate_scale else 0
    n_x = 3 * K + 3 + ns
    rows = []
    rhs = []
    for k in range(K - 1):
        pre = pres[k]
        dt = pre.dt
        if dt <= 1e-6:
            return None
        Rk = np.asarray(R_wb[k], np.float64)
        # position row block: -v_k*dt - 0.5*g*dt^2 + s*dp_vis = Rk@dp
        A = np.zeros((3, n_x))
        A[:, 3 * k:3 * k + 3] = -np.eye(3) * dt
        A[:, 3 * K:3 * K + 3] = -0.5 * dt * dt * np.eye(3)
        dp_vis = np.asarray(p_vis[k + 1], np.float64) \
            - np.asarray(p_vis[k], np.float64)
        if estimate_scale:
            A[:, -1] = dp_vis
            rhs.append(Rk @ pre.dp)
        else:
            rhs.append(Rk @ pre.dp - dp_vis)
        rows.append(A)
        # velocity row block: v_{k+1} - v_k - g*dt = Rk@dv
        B = np.zeros((3, n_x))
        B[:, 3 * k:3 * k + 3] = -np.eye(3)
        B[:, 3 * (k + 1):3 * (k + 1) + 3] = np.eye(3)
        B[:, 3 * K:3 * K + 3] = -dt * np.eye(3)
        rows.append(B)
        rhs.append(Rk @ pre.dv)
    A = np.concatenate(rows)
    b = np.concatenate(rhs)
    x, res, rank, _ = np.linalg.lstsq(A, b, rcond=None)
    if rank < n_x:
        return None
    g = x[3 * K:3 * K + 3]
    gn = float(np.linalg.norm(g))
    if gn < 0.5 * gravity_mag or gn > 2.0 * gravity_mag:
        return None

    # Gravity refinement with |g| FIXED (VINS-Mono RefineGravity): the
    # free 3-DoF gravity above is near-degenerate with scale over short
    # smooth windows (measured: exact-pose synthetic windows solve with
    # ~zero residual and 3x scale error). Re-solve with g = G*ghat + B@w,
    # B an orthonormal basis of ghat's tangent plane (2 DoF), iterating
    # the linearization point a few times.
    gcols = slice(3 * K, 3 * K + 3)
    for _ in range(4):
        ghat = g / np.linalg.norm(g)
        # tangent basis via Gram-Schmidt against the least-aligned axis
        seed = np.eye(3)[int(np.argmin(np.abs(ghat)))]
        b1 = seed - ghat * (ghat @ seed)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(ghat, b1)
        B = np.stack([b1, b2], axis=1)              # [3, 2]
        A2 = np.concatenate([A[:, :3 * K], A[:, gcols] @ B,
                             A[:, 3 * K + 3:]], axis=1)
        b2r = b - A[:, gcols] @ (ghat * gravity_mag)
        x2, _, rank2, _ = np.linalg.lstsq(A2, b2r, rcond=None)
        if rank2 < A2.shape[1]:
            return None
        g = ghat * gravity_mag + B @ x2[3 * K:3 * K + 2]
    g = g / np.linalg.norm(g) * gravity_mag
    x = np.concatenate([x2[:3 * K], g,
                        x2[3 * K + 2:]])            # repack full solution
    scale = float(x[-1]) if estimate_scale else 1.0
    if estimate_scale and not (1e-3 < scale < 1e3):
        return None
    resid = float(np.linalg.norm(A @ x - b) / max(np.linalg.norm(b), 1e-9))
    return dict(scale=scale,
                g_w=g.astype(np.float64),
                v_w=x[:3 * K].reshape(K, 3),
                residual=resid)


# ---------------------------------------------------------------------------
# Synthetic IMU from a pose trajectory (tests / demos; the dataset-side
# counterpart of EuRoC's imu0 stream)
# ---------------------------------------------------------------------------

def _slerp(R0: np.ndarray, R1: np.ndarray, f: float) -> np.ndarray:
    return R0 @ exp_so3(f * log_so3(R0.T @ R1))


def imu_from_poses(times: np.ndarray, c2w: np.ndarray, rate: float = 200.0,
                   gravity_mag: float = GRAVITY,
                   noise_gyro: float = 0.0, noise_accel: float = 0.0,
                   seed: int = 0) -> list[np.ndarray]:
    """Generate per-interval IMU sample arrays from a camera-to-world pose
    sequence: upsample (slerp + cubic-in-time position) to `rate`, then
    finite-difference for body-frame angular velocity and specific force
    (accelerometer = R_wb^T (a_w - g_w) with g_w = (0, 0, -G) world down).

    Returns a list of length len(times)-1; element i is the [K, 7] sample
    block covering (times[i], times[i+1]] — what `track(frame, imu=...)`
    expects for frame i+1."""
    times = np.asarray(times, np.float64)
    n = len(times)
    assert c2w.shape == (n, 4, 4)
    rng = np.random.default_rng(seed)
    g_w = np.array([0.0, 0.0, -gravity_mag])
    out = []
    for i in range(n - 1):
        t0, t1 = times[i], times[i + 1]
        m = max(int(np.ceil((t1 - t0) * rate)), 4)
        ts = np.linspace(t0, t1, m + 1)
        # neighbourhood for the finite differences: sample a step beyond
        # both ends (clamped at the trajectory boundary)
        def pose_at(t):
            t = float(np.clip(t, times[0], times[-1]))
            j = int(np.clip(np.searchsorted(times, t) - 1, 0, n - 2))
            f = (t - times[j]) / max(times[j + 1] - times[j], 1e-9)
            R = _slerp(c2w[j, :3, :3].astype(np.float64),
                       c2w[j + 1, :3, :3].astype(np.float64), f)
            # cubic (Catmull-Rom) position through the 4 neighbours
            j0, j1, j2, j3 = (max(j - 1, 0), j, j + 1, min(j + 2, n - 1))
            P = c2w[[j0, j1, j2, j3], :3, 3].astype(np.float64)
            f2, f3 = f * f, f * f * f
            p = 0.5 * ((2 * P[1]) + (-P[0] + P[2]) * f
                       + (2 * P[0] - 5 * P[1] + 4 * P[2] - P[3]) * f2
                       + (-P[0] + 3 * P[1] - 3 * P[2] + P[3]) * f3)
            return R, p
        h = 0.5 / rate
        rowblock = np.zeros((m + 1, 7))
        for k, t in enumerate(ts):
            R, _ = pose_at(t)
            Rp, pp = pose_at(t + h)
            Rm, pm = pose_at(t - h)
            _, p0 = pose_at(t)
            w_body = log_so3(Rm.T @ Rp) / (2 * h)
            a_w = (pp - 2 * p0 + pm) / (h * h)
            a_body = R.T @ (a_w - g_w)
            rowblock[k, 0] = t
            rowblock[k, 1:4] = w_body + rng.normal(0, noise_gyro, 3)
            rowblock[k, 4:7] = a_body + rng.normal(0, noise_accel, 3)
        out.append(rowblock.astype(np.float64))
    return out
