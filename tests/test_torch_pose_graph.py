"""legslam_torch's SE(3) / Sim(3) pose graph (slam/pose_graph.py, host
numpy in float64) against legslam_tpu's on the scenes of
tests/test_pose_graph.py: every output within 1e-12 (expected identical),
and the scenes' own claims checked on the port."""
import numpy as np
import pytest

from legslam_tpu.slam import pose_graph as JP
from legslam_torch.slam import pose_graph as TP
from tests.test_pose_graph import _circle_poses


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=1e-12,
                               rtol=0)


def _drifted(K, step, scale_drift=None):
    gt = _circle_poses(K)
    poses = [gt[0]]
    drift = JP.se3_exp(np.asarray(step)) if step is not None else np.eye(4)
    for k in range(1, K):
        M = np.linalg.inv(gt[k - 1]) @ gt[k]
        if scale_drift is not None:
            M = M.copy()
            M[:3, 3] *= scale_drift(k)
        poses.append(poses[-1] @ M @ drift)
    return gt, np.stack(poses)


def _se3_roundtrips(P):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(50):
        xi = rng.normal(0, 1.0, 6)
        T = P.se3_exp(xi)
        out += [T, P.se3_log(T)]
    rng = np.random.default_rng(3)
    for th in (np.pi - 1e-6, np.pi - 1e-3, np.pi * 0.999):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        xi = np.concatenate([th * axis, rng.normal(0, 0.5, 3)])
        out.append(P.se3_exp(P.se3_log(P.se3_exp(xi))))
    out.append(P.se3_log(P.se3_exp(np.array([1e-12, 0, 0, 0.3, -0.2, 0.1]))))
    return out


def _loop_pulls_back_drift(P):
    K = 24
    gt, poses = _drifted(K, [0.0, 0.0, 0.02, 0.015, -0.01, 0.0])
    cons = P.chain_constraints(poses)
    cons.append((0, K - 1, np.linalg.inv(gt[0]) @ gt[-1], 100.0))
    opt = P.optimize_pose_graph(poses, cons, fixed={0})
    assert np.linalg.norm(opt[-1, :3, 3] - gt[-1, :3, 3]) < 0.05
    return [opt]


def _consistent_fixed_point(P):
    gt = _circle_poses(10)
    return [P.optimize_pose_graph(gt, P.chain_constraints(gt), fixed={0})]


def _near_pi_loop(P):
    gt = _circle_poses(8)
    cons = P.chain_constraints(gt)
    flip = np.eye(4)
    flip[:3, :3] = P.se3_exp(np.array([np.pi - 1e-9, 0, 0, 0, 0, 0]))[:3, :3]
    cons.append((0, 7, flip, 50.0))
    opt = P.optimize_pose_graph(gt, cons, fixed={0})
    assert np.isfinite(opt).all()
    return [opt]


def _banded_chain(P):
    K = 300
    gt, poses = _drifted(K, [0, 0, 0.002, 0.0015, -0.001, 0])
    cons = P.chain_constraints(poses)
    cons.append((0, K - 1, np.linalg.inv(gt[0]) @ gt[-1], 100.0))
    return [P.optimize_pose_graph(poses, cons, fixed={0})]


def _sim3_roundtrips(P):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(50):
        xi = rng.normal(0, 0.8, 7)
        T = P.sim3_exp(xi)
        out += [T, P.sim3_log(T)]
    for xi in (np.array([0, 0, 0, 0.3, -0.2, 0.1, 0.4]),
               np.array([0.5, -0.2, 0.1, 0.3, -0.2, 0.1, 0.0]),
               np.array([1e-12, 0, 0, 0.3, -0.2, 0.1, 1e-12])):
        out.append(P.sim3_log(P.sim3_exp(xi)))
    R = P.se3_exp(np.array([0.2, -0.4, 0.1, 0, 0, 0]))[:3, :3]
    T = P.sim3_matrix(R, np.array([1.0, 2.0, -3.0]), 1.7)
    return out + [T, *P.sim3_parts(T)]


def _sim3_adjoints(P):
    rng = np.random.default_rng(11)
    return [P._sim3_adjoint(P.sim3_exp(rng.normal(0, 0.6, 7)))
            for _ in range(10)]


def _sim3_loop(P):
    K, s_step = 20, 1.03
    gt, S = _drifted(K, None, scale_drift=lambda k: s_step ** k)
    cons = P.chain_constraints(S)
    Mrel = np.linalg.inv(gt[0]) @ gt[-1]
    cons.append((0, K - 1, P.sim3_matrix(Mrel[:3, :3], Mrel[:3, 3],
                                         s_step ** -(K - 1)), 100.0))
    opt = P.optimize_sim3_graph(S, cons, fixed={0})
    assert abs(P.sim3_parts(opt[-1])[2] - s_step ** -(K - 1)) < 0.05
    return [opt]


def _sim3_banded_chain(P):
    K = 250
    gt, S = _drifted(K, None, scale_drift=lambda k: 1.002 ** k)
    cons = P.chain_constraints(S)
    Mrel = np.linalg.inv(gt[0]) @ gt[-1]
    cons.append((0, K - 1, P.sim3_matrix(Mrel[:3, :3], Mrel[:3, 3],
                                         1.0 / 1.002 ** (K - 1)), 100.0))
    return [P.optimize_sim3_graph(S, cons, fixed={0})]


def _umeyama(P):
    rng = np.random.default_rng(4)
    src = rng.normal(size=(40, 3))
    R = P.se3_exp(np.array([0.3, -0.2, 0.5, 0, 0, 0]))[:3, :3]
    dst = 1.7 * src @ R.T + np.array([0.4, -1.0, 2.0])
    return list(P.umeyama_sim3(src, dst))


SCENES = [_se3_roundtrips, _loop_pulls_back_drift, _consistent_fixed_point,
          _near_pi_loop, _banded_chain, _sim3_roundtrips, _sim3_adjoints,
          _sim3_loop, _sim3_banded_chain, _umeyama]


@pytest.mark.parametrize("scene", SCENES, ids=lambda f: f.__name__[1:])
def test_pose_graph_matches_jax(scene):
    a, b = scene(TP), scene(JP)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _close(x, y)
