"""legslam_torch gaussian store vs legslam_tpu: 3-NN init, create_from_pcd,
Adam, the LR schedule, densify stats, and the checkpoint-layout bridge.

Tolerances: float32 values rtol 1e-5 / atol 1e-6 (the same formulas in
another reduction order; the 3-NN distances atol 4e-5: each side's f32
|x|^2 + |y|^2 - 2xy expansion rounds by up to ~4 eps max|x|^2 = 2e-5 for
this cloud, whose squared norms reach ~80); integers and masks
bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.models import gaussians as JG
from legslam_tpu.utils.knn import mean_sq_dist_to_3nn as jax_knn
from legslam_torch.models import gaussians as TG
from legslam_torch.utils.knn import mean_sq_dist_to_3nn as torch_knn

from .torch_parity import assert_close, jax_state_tree, np_, t_

torch.set_num_threads(1)


def _assert_tree_close(tree_t, tree_j, atol=1e-6, rtol=1e-5, path=""):
    if isinstance(tree_j, dict):
        assert set(tree_t) == set(tree_j), path
        for k in tree_j:
            _assert_tree_close(tree_t[k], tree_j[k], atol, rtol, f"{path}/{k}")
        return
    a, b = np.asarray(tree_t), np.asarray(tree_j)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.dtype, b.dtype)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=path)


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 8.0, size=n).astype(np.float32)
    return pts, rng.uniform(size=(n, 3)).astype(np.float32), rng


def test_knn_matches():
    pts, _, rng = _cloud(700)
    valid = rng.uniform(size=700) > 0.1
    for v in (None, valid):
        tv = torch_knn(t_(pts), None if v is None else t_(v), chunk=256)
        jv = jax_knn(jnp.asarray(pts), None if v is None else jnp.asarray(v),
                     chunk=256)
        keep = np.ones(700, bool) if v is None else v
        np.testing.assert_allclose(np_(tv)[keep], np.asarray(jv)[keep],
                                   rtol=0, atol=4e-5)


def test_create_from_pcd_matches_and_round_trips():
    pts, cols, rng = _cloud()
    lf = rng.normal(size=(300, 64)).astype(np.float32)
    js = JG.create_from_pcd(pts, cols, capacity=384, lang_feat=lf)
    ts = TG.create_from_pcd(pts, cols, capacity=384, lang_feat=lf,
                            device="cpu")
    tree_t = TG.state_to_numpy(ts)
    _assert_tree_close(tree_t, jax_state_tree(js), rtol=1e-4)
    # the checkpoint-layout bridge is lossless both ways
    back = TG.state_to_numpy(TG.state_from_numpy(tree_t, device="cpu"))
    _assert_tree_close(back, tree_t, atol=0, rtol=0)
    assert int(ts.num_valid()) == 300 and ts.capacity == 384


def test_adam_and_stats_match():
    pts, cols, rng = _cloud(200)
    js = JG.create_from_pcd(pts, cols, capacity=256)
    ts = TG.state_from_numpy(jax_state_tree(js), device="cpu")
    lrs_j = dict(xyz=JG.expon_lr(3.0, 1.6e-4, 1.6e-6, lr_delay_mult=0.01,
                                 max_steps=30_000),
                 f_dc=2.5e-3, f_rest=1.25e-4, lang_feat=1.5e-3,
                 opacity=0.05, scaling=1e-3, rotation=1e-3)
    lrs_t = dict(lrs_j, xyz=TG.expon_lr(3.0, 1.6e-4, 1.6e-6,
                                         lr_delay_mult=0.01,
                                         max_steps=30_000))
    assert_close(lrs_t["xyz"], lrs_j["xyz"], 0, 1e-6, "expon_lr")
    for step in range(3):
        grads = {n: rng.normal(size=getattr(js.params, n).shape)
                 .astype(np.float32) * 1e-3 for n in TG.GROUPS}
        js = JG.adam_update(js, JG.GaussianParams(
            **{n: jnp.asarray(g) for n, g in grads.items()}), lrs_j)
        TG.adam_update(ts, TG.GaussianParams(
            **{n: t_(g) for n, g in grads.items()}), lrs_t)
        mg = rng.normal(size=(256, 2)).astype(np.float32)
        radii = rng.integers(0, 4, size=256).astype(np.int32)
        js = JG.add_densification_stats(js, jnp.asarray(mg),
                                        jnp.asarray(radii))
        TG.add_densification_stats(ts, t_(mg), t_(radii))
    _assert_tree_close(TG.state_to_numpy(ts), jax_state_tree(js))
    assert int(ts.adam_step) == 3


@pytest.mark.parametrize("step,delay", [(0.0, 0), (100.0, 0), (-1.0, 0),
                                        (5.0, 10), (40_000.0, 0)])
def test_expon_lr_matches(step, delay):
    kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01, max_steps=30_000)
    assert_close(TG.expon_lr(step, 1.6e-4, 1.6e-6, **kw),
                 JG.expon_lr(step, 1.6e-4, 1.6e-6, **kw), 0, 1e-6)
    assert float(TG.expon_lr(step, 0.0, 0.0)) == 0.0


def test_adam_matches_torch_optim():
    """adam_update is torch.optim.Adam (eps 1e-15) on every group."""
    pts, cols, rng = _cloud(50)
    ts = TG.create_from_pcd(pts, cols, capacity=64, device="cpu")
    ref = {n: getattr(ts.params, n).clone().requires_grad_(True)
           for n in TG.GROUPS}
    lrs = dict(xyz=1e-3, f_dc=2.5e-3, f_rest=1.25e-4, lang_feat=1.5e-3,
               opacity=0.05, scaling=1e-3, rotation=1e-3)
    opt = torch.optim.Adam([{"params": [ref[n]], "lr": lrs[n]}
                            for n in TG.GROUPS], eps=1e-15)
    for _ in range(3):
        grads = {n: torch.randn(ref[n].shape) for n in TG.GROUPS}
        for n in TG.GROUPS:
            ref[n].grad = grads[n].clone()
        opt.step()
        TG.adam_update(ts, TG.GaussianParams(**grads), lrs)
    for n in TG.GROUPS:
        assert_close(getattr(ts.params, n), ref[n].detach(), 1e-6, 1e-5, n)
