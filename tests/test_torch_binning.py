"""legslam_torch binning vs legslam_tpu: every Binning field bit-exact.

Both sides bin the SAME preprocessed gaussians (computed once by the JAX
prologue and handed over as numpy), so the comparison isolates binning:
tile rects, the opacity-aware radius and ellipse cull, the packed-key
sort, the sentinel ids and the tile ranges, and the kfin trim.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.ops import binning as JB
from legslam_tpu.ops.projection import Preprocessed as JPre
from legslam_tpu.ops.projection import preprocess as jax_preprocess
from legslam_tpu.utils.transforms import normalize_quat
from legslam_torch.config import RasterizeConfig
from legslam_torch.ops import binning as TB
from legslam_torch.ops.projection import Preprocessed

from .torch_parity import np_, t_
from .util import random_scene, simple_view

torch.set_num_threads(1)

W, H = 256, 96


@pytest.fixture(scope="module")
def pre_np():
    rng = np.random.default_rng(7)
    scene = random_scene(rng, n=400, capacity=512, spread=1.3)
    view = simple_view(width=W, height=H)
    pre = jax_preprocess(
        jnp.asarray(scene["means3d"]), jnp.asarray(scene["scales"]),
        normalize_quat(jnp.asarray(scene["quats"])),
        jnp.asarray(scene["valid"]), view.world_view, view.full_proj, W, H,
        view.focal_x, view.focal_y, view.tan_fovx, view.tan_fovy)
    return {k: np.asarray(v) for k, v in pre._asdict().items()}, \
        scene["opacity"]


def _both(pre_np):
    pre, _ = pre_np
    return JPre(**{k: jnp.asarray(v) for k, v in pre.items()}), \
        Preprocessed(**{k: t_(v) for k, v in pre.items()})


def _assert_binning_equal(bt, bj):
    for field in bj._fields:
        np.testing.assert_array_equal(np_(getattr(bt, field)),
                                      np_(getattr(bj, field)),
                                      err_msg=field)


@pytest.mark.parametrize("span,cull,compositor", [
    ((4, 8), True, "kernels"),
    ((4, 8), False, "kernels"),
    ((3, 8), True, "reference"),
    ((1, 2), True, "kernels"),      # the span cap drops pairs
])
def test_bin_gaussians_bit_exact(pre_np, span, cull, compositor):
    pj, pt = _both(pre_np)
    op = pre_np[1]
    kw = dict(max_span_x=span[0], max_span_y=span[1], chunk=64,
              max_pairs=1 << 12)
    cfg_j = JaxCfg(**kw, backend="pallas" if compositor == "kernels"
                   else "xla")
    cfg_t = RasterizeConfig(**kw, backend="cuda" if compositor == "kernels"
                            else "torch")
    bj = JB.bin_gaussians(pj, W, H, cfg_j,
                          opacity=jnp.asarray(op) if cull else None)
    bt = TB.bin_gaussians(pt, W, H, cfg_t, opacity=t_(op) if cull else None)
    _assert_binning_equal(bt, bj)
    assert int(bt.num_rendered) > 0
    if span == (1, 2):
        assert int(bt.span_overflow) > 0


@pytest.mark.parametrize("cull", [True, False])
def test_cuda_sort_binning_matches_pallas_sort(pre_np, cull):
    """cuda_sort=True (the sort kernels' plain versions here) against the
    JAX Pallas bitonic sorts in interpret mode. The Pallas network leaves
    tied keys in no fixed order, so the scene is asserted to have distinct
    valid depths; the invalid gaussians (all tied at FLT_MAX) end the depth
    order in an order of its own there, so that tail is compared as a
    set. Every other field, the valid prefix of the order included, is
    bit for bit."""
    pj, pt = _both(pre_np)
    pre, op = pre_np
    depth = pre["depth"][pre["mask"]]
    assert np.unique(depth).size == depth.size > 100
    kw = dict(chunk=64, max_pairs=1 << 12)
    bj = JB.bin_gaussians(pj, W, H, JaxCfg(**kw, backend="pallas",
                                           pallas_sort=True,
                                           pallas_interpret=True),
                          opacity=jnp.asarray(op) if cull else None)
    bt = TB.bin_gaussians(pt, W, H, RasterizeConfig(**kw, backend="cuda",
                                                    cuda_sort=True),
                          opacity=t_(op) if cull else None)
    nv = int(pre["mask"].sum())
    np.testing.assert_array_equal(np_(bt.order)[:nv], np_(bj.order)[:nv])
    np.testing.assert_array_equal(np.sort(np_(bt.order)[nv:]),
                                  np.sort(np_(bj.order)[nv:]))
    for field in bj._fields[1:]:
        np.testing.assert_array_equal(np_(getattr(bt, field)),
                                      np_(getattr(bj, field)),
                                      err_msg=field)
    assert int(bt.num_rendered) > 0


def test_cuda_sort_binning_equals_torch_sort_with_ties(pre_np):
    """The sort kernels order ties as a stable sort does, so the flag does
    not change the Binning, bit for bit, even where depths tie."""
    pre, op = pre_np
    tied = dict(pre, depth=np.round(pre["depth"] * 8.0) / 8.0)
    d = tied["depth"][tied["mask"]]
    assert np.unique(d).size < d.size
    pt = Preprocessed(**{k: t_(v) for k, v in tied.items()})
    out = [TB.bin_gaussians(pt, W, H, RasterizeConfig(
        chunk=64, max_pairs=1 << 12, backend="cuda", cuda_sort=flag),
        opacity=t_(op)) for flag in (False, True)]
    _assert_binning_equal(*out)


def test_tile_rect_and_effective_radius_exact(pre_np):
    pre, op = pre_np
    rj = JB.effective_radius(jnp.asarray(pre["radius"]), jnp.asarray(op))
    rt = TB.effective_radius(t_(pre["radius"]), t_(op))
    np.testing.assert_array_equal(np_(rt), np_(rj))
    tj = JB.tile_rect(jnp.asarray(pre["mean2d"]), rj, 128, 16, 2, 6)
    tt = TB.tile_rect(t_(pre["mean2d"]), rt, 128, 16, 2, 6)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(np_(a), np_(b))


def _random_binning(npair, ntiles, chunk, seed, P=64):
    """A flat binning with random tile counts (the JAX suite's trim
    oracle cases, tests/test_binning_trim.py)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 * chunk + 5, size=ntiles)
    if seed == 2:
        counts[::3] = 0   # zero-count tiles sharing a start
    total = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pair_gid = np.full(npair, P, np.int32)
    pair_gid[:total] = rng.integers(0, P, size=total)
    max_chunks = -(-int(counts.max() or 1) // chunk) + 1
    kfin = rng.integers(0, max_chunks + 1, size=ntiles).astype(np.int32)
    fields = dict(order=np.arange(P, dtype=np.int32), pair_gid=pair_gid,
                  tile_start=starts.astype(np.int32),
                  tile_count=counts.astype(np.int32),
                  num_rendered=np.int32(total), span_overflow=np.int32(0))
    return fields, kfin


@pytest.mark.parametrize("npair,ntiles,chunk,seed,max_pairs,slack", [
    (128, 7, 8, 0, 128, 1),
    (100, 5, 16, 1, 100, 1),
    (256, 12, 8, 2, 256, 2),
    (256, 12, 8, 3, 96, 1),    # max_pairs clips tile ranges
])
def test_trim_binning_bit_exact(npair, ntiles, chunk, seed, max_pairs,
                                slack):
    fields, kfin = _random_binning(npair, ntiles, chunk, seed)
    bj = JB.trim_binning(JB.Binning(**{k: jnp.asarray(v) for k, v in
                                       fields.items()}),
                         jnp.asarray(kfin), max_pairs=max_pairs, chunk=chunk,
                         slack_chunks=slack)
    bt = TB.trim_binning(TB.Binning(**{k: t_(v) for k, v in fields.items()}),
                         t_(kfin), max_pairs=max_pairs, chunk=chunk,
                         slack_chunks=slack)
    _assert_binning_equal(bt, bj)


def test_trim_of_real_binning_bit_exact(pre_np):
    pj, pt = _both(pre_np)
    cfg_j = JaxCfg(chunk=64, max_pairs=1 << 12, backend="pallas")
    cfg_t = RasterizeConfig(**{f.name: getattr(cfg_j, f.name) for f in
                               dataclasses.fields(RasterizeConfig)
                               if f.name not in ("backend", "cuda_sort")},
                            backend="cuda")
    op = pre_np[1]
    bj = JB.bin_gaussians(pj, W, H, cfg_j, opacity=jnp.asarray(op))
    bt = TB.bin_gaussians(pt, W, H, cfg_t, opacity=t_(op))
    kfin = np.random.default_rng(0).integers(
        0, 3, size=bj.tile_start.shape[0]).astype(np.int32)
    tj = JB.trim_binning(bj, jnp.asarray(kfin), 1 << 12, 64)
    tt = TB.trim_binning(bt, t_(kfin), 1 << 12, 64)
    _assert_binning_equal(tt, tj)
    assert int(tt.num_rendered) < int(bt.num_rendered)
