"""The four public helpers of legslam_tpu that the port gained last, held
against JAX on the same seeded numpy inputs: utils/sh.sh_to_rgb,
utils/camera.fov2focal, utils/transforms.unpack_sym6 and
ops/projection.compute_cov2d (which shares preprocess's EWA formula,
_cov2d_cols).

Tolerances: sh_to_rgb atol 1e-7; fov2focal 1e-12 and round-tripped
through focal2fov; unpack_sym6 exact (a relayout); compute_cov2d atol
1e-6 / rtol 1e-5 (f32 reassociation of the same formula).
"""
import math

import numpy as np
import pytest
import torch

from legslam_tpu.ops import projection as JP
from legslam_tpu.utils import camera as JC
from legslam_tpu.utils import sh as JS
from legslam_tpu.utils import transforms as JT
from legslam_torch.ops import projection as TP
from legslam_torch.utils import camera as TC
from legslam_torch.utils import sh as TS
from legslam_torch.utils import transforms as TT

from .torch_parity import np_, t_

torch.set_num_threads(1)


def test_sh_to_rgb_matches():
    rng = np.random.default_rng(0)
    sh = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(TS.sh_to_rgb(t_(sh))),
                               np.asarray(JS.sh_to_rgb(sh)), atol=1e-7)
    # the inverse of rgb_to_sh
    rgb = rng.uniform(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(TS.sh_to_rgb(TS.rgb_to_sh(t_(rgb)))),
                               rgb, atol=1e-7)


@pytest.mark.parametrize("pixels", [160, 640, 1200])
def test_fov2focal_matches(pixels):
    rng = np.random.default_rng(pixels)
    for fov in rng.uniform(0.2, 2.5, size=8):
        f = TC.fov2focal(float(fov), pixels)
        assert abs(f - JC.fov2focal(float(fov), pixels)) <= 1e-12 * f
        assert math.isclose(TC.focal2fov(f, pixels), fov, rel_tol=1e-12)


def test_unpack_sym6_matches():
    rng = np.random.default_rng(1)
    c = rng.normal(size=(5, 7, 6)).astype(np.float32)
    got = np_(TT.unpack_sym6(t_(c)))
    want = np.asarray(JT.unpack_sym6(c))
    assert got.shape == (5, 7, 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))


@pytest.mark.parametrize("with_valid", [False, True])
def test_compute_cov2d_matches(with_valid):
    """Points spread wide enough that some project past the 1.3 x fov
    view-space clamp, and a few behind the camera (guarded by `valid`)."""
    rng = np.random.default_rng(2)
    n = 256
    means = (rng.normal(size=(n, 3)) * [3.0, 2.0, 1.2]
             + [0.0, 0.0, 2.0]).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-3.0, -0.5, size=(n, 3))).astype(np.float32)
    cov3d = np.asarray(JT.build_cov3d(s, q))
    world_view = np.eye(4, dtype=np.float32)
    world_view[:3, 3] = [0.1, -0.05, 0.2]
    fx, fy, w, h = 300.0, 280.0, 320, 192
    tan_x, tan_y = w / (2 * fx), h / (2 * fy)
    z = means[:, 2] + 0.2
    clamped = (np.abs(means[:, 0] / z) > 1.3 * tan_x) & (z > 0.2)
    assert clamped.sum() >= 10 and (~clamped).sum() >= 10
    valid = z > 0.2 if with_valid else None
    if with_valid:
        assert (~valid).sum() >= 3
    got = TP.compute_cov2d(t_(means), t_(cov3d), t_(world_view), fx, fy,
                           tan_x, tan_y,
                           None if valid is None else torch.as_tensor(valid))
    want = np.asarray(JP.compute_cov2d(means, cov3d, world_view, fx, fy,
                                       tan_x, tan_y, valid))
    assert got.shape == (n, 3)
    assert np.isfinite(np_(got)).all()
    np.testing.assert_allclose(np_(got), want, atol=1e-6, rtol=1e-5)
