"""Trajectory file writers: TUM / EuRoC / KITTI formats.

A copy of legslam_tpu/utils/trajectory_io.py.

Parity with the reference's end-of-run saves (examples/replica_rgbd.cpp:
208-218 calls System::SaveTrajectoryTUM / SaveTrajectoryEuRoC /
SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI,
ORB-SLAM3/src/System.cc):

  TUM:   "ts tx ty tz qx qy qz qw" (seconds, camera-to-world)
  EuRoC: "ts_ns tx ty tz qw qx qy qz" (nanoseconds, w-first quaternion)
  KITTI: 12 numbers per line — the row-major 3x4 camera-to-world matrix

No torch/Eigen: quaternions via the same numpy path the frontend uses.
"""
from __future__ import annotations

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[3,3] -> (w, x, y, z), positive-trace branch with fallbacks."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _c2w_list(stamps, c2ws):
    for ts, T in zip(stamps, c2ws):
        R, t = np.asarray(T[:3, :3]), np.asarray(T[:3, 3])
        yield float(ts), R, t, _rot_to_quat(R)


def save_trajectory_tum(path: str, stamps, c2ws) -> None:
    with open(path, "w") as f:
        for ts, R, t, q in _c2w_list(stamps, c2ws):
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_trajectory_euroc(path: str, stamps, c2ws) -> None:
    with open(path, "w") as f:
        for ts, R, t, q in _c2w_list(stamps, c2ws):
            f.write(f"{int(round(ts * 1e9))} "
                    f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_trajectory_kitti(path: str, stamps, c2ws) -> None:
    with open(path, "w") as f:
        for _, R, t, _ in _c2w_list(stamps, c2ws):
            M = np.concatenate([R, t[:, None]], axis=1).ravel()
            f.write(" ".join(f"{v:.9e}" for v in M) + "\n")


def load_trajectory_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (stamps [N], c2w [N,4,4])."""
    rows = np.loadtxt(path).reshape(-1, 8)
    out = []
    for r in rows:
        x, y, z, qx, qy, qz, qw = r[1:]
        n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, (x, y, z)
        out.append(T)
    return rows[:, 0], np.stack(out).astype(np.float32)
