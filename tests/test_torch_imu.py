"""legslam_torch's IMU preintegration and visual-inertial helpers
(slam/imu.py, host numpy in float64) against legslam_tpu's on the scenes
of the non-slow part of tests/test_tracking_imu.py: every output within
1e-12 (expected identical), and the scenes' own claims checked on the
port."""
import numpy as np
import pytest

from legslam_tpu.slam import imu as JI
from legslam_torch.slam import imu as TI
from tests.test_tracking_imu import _circle_trajectory


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=1e-12,
                                   rtol=0)


def _pre(p):
    return [p.dR, p.dv, p.dp, p.dt, p.n]


def _constant_motion(I):
    w, a_w = np.array([0.0, 0.0, 0.4]), np.array([0.3, -0.1, 0.05])
    rate = 400.0
    ts = np.arange(0.0, 1.0 + 0.5 / rate, 1.0 / rate)
    rows = np.zeros((len(ts), 7))
    rows[:, 0] = ts
    for k, t in enumerate(ts):
        rows[k, 1:4] = w
        rows[k, 4:7] = I.exp_so3(w * t).T @ a_w
    pre = I.preintegrate(rows)
    np.testing.assert_allclose(pre.dv, a_w, atol=2e-3)
    return _pre(pre) + [I.log_so3(pre.dR), I.hat(w)]


def _merge(I):
    rng = np.random.default_rng(3)
    ts = np.sort(rng.uniform(0, 1, 64))
    rows = np.concatenate([ts[:, None], rng.normal(0, 0.5, (64, 6))], 1)
    m = I.preintegrate(rows[:40]).merge(I.preintegrate(rows[39:]))
    return _pre(I.preintegrate(rows)) + _pre(m)


def _align(I):
    times, c2w = _circle_trajectory()
    blocks = I.imu_from_poses(times, c2w, rate=200.0)
    R_wb = [c2w[k, :3, :3] for k in range(len(times))]
    p_vis = [c2w[k, :3, 3] / 3.7 for k in range(len(times))]
    pres = [I.preintegrate(b) for b in blocks]
    out = I.align_visual_inertial(R_wb, p_vis, pres)
    assert abs(out["scale"] - 3.7) / 3.7 < 0.05
    R2, p2, v2 = I.predict_pose(R_wb[3], p_vis[3], np.array([0.1, 0, 0]),
                                out["g_w"], pres[3])
    return blocks + [out, R2, p2, v2]


def _degenerate(I):
    n, dt = 6, 0.5
    times = np.arange(n) * dt
    c2w = np.tile(np.eye(4), (n, 1, 1))
    c2w[:, 0, 3] = 0.4 * times
    pres = [I.preintegrate(b)
            for b in I.imu_from_poses(times, c2w, rate=200.0)]
    out = I.align_visual_inertial([c2w[k, :3, :3] for k in range(n)],
                                  [c2w[k, :3, 3] for k in range(n)], pres)
    assert out is None or out["residual"] > 0.1
    return [out]


def _noisy_blocks(I):
    times, c2w = _circle_trajectory(n=6)
    return I.imu_from_poses(times, c2w, rate=100.0, noise_gyro=0.01,
                            noise_accel=0.05, seed=4)


SCENES = [_constant_motion, _merge, _align, _degenerate, _noisy_blocks]


@pytest.mark.parametrize("scene", SCENES, ids=lambda f: f.__name__[1:])
def test_imu_matches_jax(scene):
    a, b = scene(TI), scene(JI)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _close(x, y)
