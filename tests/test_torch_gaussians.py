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


# --- the store surgery of the online mapper --------------------------------
# Points on a 1/8 lattice: their squared distances are exact in float32 on
# both sides, so the 3-NN scale init agrees to an ulp of the log and the
# surgery's params hold at atol 1e-6; masks, slots and counts bit-exact.

SURGERY_ATOL = 1e-6


def _lattice(n, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.integers(-24, 24, size=(n, 3)) / 8.0).astype(np.float32)
    return pts, rng.uniform(size=(n, 3)).astype(np.float32), rng


def _both_states(js):
    return js, TG.state_from_numpy(jax_state_tree(js), device="cpu")


def _assert_states(ts, js):
    _assert_tree_close(TG.state_to_numpy(ts), jax_state_tree(js),
                       atol=SURGERY_ATOL, rtol=0)


def test_allocate_slots_matches():
    rng = np.random.default_rng(3)
    for frac_valid in (0.2, 0.9):
        valid = rng.uniform(size=300) < frac_valid
        want = rng.uniform(size=300) < 0.5
        pj = JG._allocate_slots(jnp.asarray(valid), jnp.asarray(want), 300)
        pt = TG._allocate_slots(t_(valid), t_(want))
        np.testing.assert_array_equal(np_(pt.slots), np.asarray(pj.slots))
        assert int(pt.n_dropped) == int(pj.n_dropped)
    assert int(pt.n_dropped) > 0


@pytest.mark.parametrize("capacity", [512, 256])
def test_increase_pcd_matches(capacity):
    """A padded ingest bucket (point_valid masks the tail, max_log_scale
    caps some rows); at capacity 256 the batch overflows the free slots
    and the dropped count must agree."""
    pts, cols, rng = _lattice(200, 1)
    js, ts = _both_states(JG.create_from_pcd(pts, cols, capacity=capacity))
    new, ncols, _ = _lattice(128, 2)
    pv = np.arange(128) < 100
    smax = np.where(rng.uniform(size=128) < 0.5, -1.5, np.inf) \
        .astype(np.float32)
    js = JG.increase_pcd(js, jnp.asarray(new), jnp.asarray(ncols),
                         jnp.int32(7), point_valid=jnp.asarray(pv),
                         max_log_scale=jnp.asarray(smax))
    out = TG.increase_pcd(ts, t_(new), t_(ncols), 7, point_valid=t_(pv),
                          max_log_scale=t_(smax))
    _assert_states(out, js)
    assert int(out.overflow_dropped) == (44 if capacity == 256 else 0)
    assert int(ts.num_valid()) == 200      # the input state is kept


def test_grow_capacity_matches():
    pts, cols, _ = _lattice(100, 4)
    js, ts = _both_states(JG.create_from_pcd(pts, cols, capacity=128))
    out = TG.grow_capacity(ts, 512)
    _assert_states(out, JG.grow_capacity(js, 512))
    assert out.capacity == 512 and int(out.num_valid()) == 100


def _densify_state(capacity, seed=5):
    """A JAX store with clone, split and prune candidates."""
    pts, cols, rng = _lattice(200, seed)
    js = JG.create_from_pcd(pts, cols, capacity=capacity)
    op = rng.uniform(0.005, 0.99, size=(capacity, 1)).astype(np.float32)
    sc = np.asarray(js.params.scaling) + rng.uniform(
        -0.5, 0.8, size=(capacity, 3)).astype(np.float32)
    stats = JG.DensifyStats(
        grad_accum=jnp.asarray(rng.uniform(0, 3e-3, capacity), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 10, capacity), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, capacity), jnp.float32))
    return js.replace(params=js.params.replace(
        opacity=jnp.asarray(np.log(op / (1 - op))),
        scaling=jnp.asarray(sc)), stats=stats)


@pytest.mark.parametrize("capacity,max_screen", [(1024, None), (1024, 20.0),
                                                 (256, 20.0)])
def test_densify_and_prune_matches(capacity, max_screen):
    """Clone, split (fed JAX's own split noise) and prune; at capacity 256
    the children overflow the free slots."""
    import jax
    js, ts = _both_states(_densify_state(capacity))
    key = jax.random.key(11)
    # the draws densify_and_prune makes from `key` (gaussians.py:469-471)
    noise, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        noise.append(np.array(jax.random.normal(sub, (capacity, 3))))
    args = (2e-4, 0.02, 3.0, max_screen, 0.01)
    jo = JG.densify_and_prune(js, key, *args)
    to = TG.densify_and_prune(ts, None, *args, noise=noise)
    _assert_states(to, jo)
    n_before, n_after = int(js.num_valid()), int(jo.num_valid())
    assert n_after != n_before
    assert (int(to.overflow_dropped) > 0) == (capacity == 256)


def test_densify_and_prune_draws_from_generator():
    """Without `noise` the split draws come from the generator: one seed,
    one result."""
    _, ts = _both_states(_densify_state(1024))
    outs = [TG.densify_and_prune(
        ts, torch.Generator().manual_seed(0), 2e-4, 0.02, 3.0, None, 0.01)
        for _ in range(2)]
    assert torch.equal(outs[0].params.xyz, outs[1].params.xyz)
    assert torch.equal(outs[0].valid, outs[1].valid)


def test_reset_opacity_matches():
    js, ts = _both_states(_densify_state(256))
    _assert_states(TG.reset_opacity(ts), JG.reset_opacity(js))


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(JG.quat_to_rotmat(jnp.asarray(q, jnp.float32)))


def test_loop_closure_surgery_matches():
    """rotmat_to_quat, apply_scaled_transformation, mark_visible and
    transform_visible_points against JAX."""
    js, ts = _both_states(_densify_state(256))
    rng = np.random.default_rng(8)
    Rs = np.stack([_rotation(rng) for _ in range(16)]).astype(np.float32)
    assert_close(TG.rotmat_to_quat(t_(Rs)), JG.rotmat_to_quat(
        jnp.asarray(Rs)), SURGERY_ATOL, 0)
    R, t = Rs[0], rng.normal(size=3).astype(np.float32)
    _assert_states(
        TG.apply_scaled_transformation(ts, 1.3, t_(R), t_(t)),
        JG.apply_scaled_transformation(js, 1.3, jnp.asarray(R),
                                       jnp.asarray(t)))
    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, :3], w2v[2, 3] = Rs[1], 0.5
    exist = rng.integers(0, 60, size=256).astype(np.int32)
    js = js.replace(exist_since=jnp.asarray(exist))
    ts.exist_since = t_(exist)
    nt = rng.uniform(size=256) < 0.8
    jo, jm, jn = JG.transform_visible_points(
        js, jnp.asarray(nt), jnp.asarray(R), jnp.asarray(t),
        jnp.asarray(w2v), 30, 30, 0.9)
    to, tm, tn = TG.transform_visible_points(
        ts, t_(nt), t_(R), t_(t), t_(w2v), 30, 30, 0.9)
    _assert_states(to, jo)
    np.testing.assert_array_equal(np_(tm), np.asarray(jm))
    assert int(tn) == int(jn) > 0
