"""legslam_torch per-gaussian prologue vs legslam_tpu: transforms, SH,
camera and preprocess, values and gradients, on the same seeded inputs.

Tolerances: values atol 1e-5 / rtol 1e-5 (f32 reassociation of the same
formulas), pixel positions atol 1e-4 (coordinates in the hundreds),
integer radius and masks bit-exact; gradients atol 1e-6 x the largest
reference gradient / rtol 1e-4.
"""
import jax
import jax.numpy as jnp
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

from .torch_parity import assert_close, np_, t_, torch_view
from .util import random_scene, simple_view

torch.set_num_threads(1)


def _grad_close(g, jg, name):
    jg = np.asarray(jg)
    assert_close(g, jg, 1e-6 * np.abs(jg).max(), 1e-4, name)


def test_transforms_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                       # a padded row
    s = np.exp(rng.uniform(-3, 0, size=(64, 3))).astype(np.float32)
    x = rng.uniform(0.01, 0.99, size=64).astype(np.float32)
    assert_close(TT.inverse_sigmoid(t_(x)), JT.inverse_sigmoid(x), 1e-5, 1e-5)
    assert_close(TT.normalize_quat(t_(q)), JT.normalize_quat(q), 1e-6, 1e-5)
    assert_close(TT.quat_to_rotmat(t_(q)), JT.quat_to_rotmat(q), 1e-6, 1e-5)
    assert_close(TT.build_cov3d(t_(s), t_(q), 0.7),
                 JT.build_cov3d(s, q, 0.7), 1e-6, 1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_color_matches(deg):
    rng = np.random.default_rng(deg)
    sh = (rng.normal(size=(50, 16, 3)) * 0.3).astype(np.float32)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    campos = np.asarray([0.1, -0.2, -1.0], np.float32)
    w = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(TS.rgb_to_sh(t_(w))),
                               np.asarray(JS.rgb_to_sh(w)), rtol=1e-6)

    def jf(s, m):
        return jnp.sum(JS.sh_to_color(deg, s, m, campos) * w)
    jval = jf(sh, means)
    jgs, jgm = jax.grad(jf, argnums=(0, 1))(sh, means)
    s_, m_ = t_(sh).requires_grad_(True), t_(means).requires_grad_(True)
    val = torch.sum(TS.sh_to_color(deg, s_, m_, t_(campos)) * t_(w))
    val.backward()
    assert_close(val.detach(), jval, 1e-5, 1e-5)
    _grad_close(s_.grad, jgs, "d sh")
    # degree 0 has no view dependence: no gradient reaches the means
    _grad_close(torch.zeros_like(m_) if m_.grad is None else m_.grad, jgm,
                "d means")


def test_camera_matches():
    rng = np.random.default_rng(1)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    np.testing.assert_array_equal(TC.world2view(R, t), JC.world2view(R, t))
    np.testing.assert_array_equal(TC.projection_matrix(1.1, 0.8),
                                  JC.projection_matrix(1.1, 0.8))
    tv = TC.CameraView.create(R, t, 200, 120, fx=150.0, fy=140.0,
                              device="cpu")
    jv = JC.CameraView.create(R, t, 200, 120, fx=150.0, fy=140.0)
    for f in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(np_(getattr(tv, f)),
                                      np.asarray(getattr(jv, f)))
    for f in ("tan_fovx", "tan_fovy", "focal_x", "focal_y"):
        assert getattr(tv, f) == getattr(jv, f)
    v = rng.uniform(-1, 1, size=17).astype(np.float32)
    assert_close(TC.ndc2pix(t_(v), 200), JC.ndc2pix(v, 200), 1e-5, 1e-6)


def test_preprocess_matches():
    rng = np.random.default_rng(2)
    scene = random_scene(rng, n=300, capacity=320, spread=1.5)
    scene["means3d"][:5, 2] = 0.1    # behind the near plane: culled
    jview = simple_view()
    view = torch_view(jview)
    args = ("means3d", "scales", "quats")

    def jpre(m, s, q):
        return JP.preprocess(m, s, q, jnp.asarray(scene["valid"]),
                             jview.world_view, jview.full_proj, jview.width,
                             jview.height, jview.focal_x, jview.focal_y,
                             jview.tan_fovx, jview.tan_fovy, 0.9)
    w2 = rng.normal(size=(320, 2)).astype(np.float32)
    w3 = rng.normal(size=(320, 3)).astype(np.float32)

    def jloss(*a):
        p = jpre(*a)
        return jnp.sum(p.mean2d * w2) + jnp.sum(p.conic * w3), p
    (_, jp), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(scene[k]) for k in args))

    leaves = [t_(scene[k]).requires_grad_(True) for k in args]
    tp = TP.preprocess(*leaves, t_(scene["valid"]), view.world_view,
                       view.full_proj, view.width, view.height, view.focal_x,
                       view.focal_y, view.tan_fovx, view.tan_fovy, 0.9)
    (torch.sum(tp.mean2d * t_(w2)) + torch.sum(tp.conic * t_(w3))).backward()
    assert_close(tp.mean2d.detach(), jp.mean2d, 1e-4, 1e-5, "mean2d")
    assert_close(tp.conic.detach(), jp.conic, 1e-5, 1e-5, "conic")
    assert_close(tp.depth.detach(), jp.depth, 1e-5, 1e-5, "depth")
    np.testing.assert_array_equal(np_(tp.radius), np.asarray(jp.radius))
    np.testing.assert_array_equal(np_(tp.mask), np.asarray(jp.mask))
    assert not np_(tp.mask)[:5].any() and np_(tp.mask).sum() > 200
    for g, jg, name in zip(leaves, jgrads, args):
        _grad_close(g.grad, jg, "d " + name)


def test_padded_rows_have_finite_grads():
    """Zero rows of the capacity-padded store (means == campos == 0, zero
    quaternions) keep every gradient finite through the prologue (the
    guarded rsqrt of sh_to_color and the quaternion normalize)."""
    rng = np.random.default_rng(3)
    scene = random_scene(rng, n=40, capacity=64)
    for k in ("means3d", "quats", "scales", "sh"):
        scene[k][40:] = 0.0
    view = torch_view(simple_view())
    leaves = {k: t_(scene[k]).requires_grad_(True)
              for k in ("means3d", "quats", "scales", "sh")}
    pre = TP.preprocess(leaves["means3d"], leaves["scales"],
                        TT.normalize_quat(leaves["quats"]),
                        t_(scene["valid"]), view.world_view, view.full_proj,
                        view.width, view.height, view.focal_x, view.focal_y,
                        view.tan_fovx, view.tan_fovy)
    rgb = TS.sh_to_color(3, leaves["sh"], leaves["means3d"], view.cam_center)
    loss = torch.sum(torch.where(pre.mask[:, None], pre.mean2d, 0.0)) + \
        torch.sum(torch.where(pre.mask[:, None], pre.conic, 0.0)) + \
        torch.sum(rgb * t_(scene["valid"][:, None].astype(np.float32)))
    loss.backward()
    for k, v in leaves.items():
        assert torch.isfinite(v.grad).all(), k
