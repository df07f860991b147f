"""legslam_torch's bucketed layout vs legslam_tpu's, and the tile-ellipse
cull switch.

* bin_gaussians_bucketed: every BucketedBinning field bit for bit against
  JAX's on the same preprocessed gaussians, with the cull on and off, and
  with a cap that drops pairs (the overflow count);
* ellipse_cull=False in both binnings, bit for bit;
* the "cuda" backend's bucketed path (prepare_pairs' bucketed branch and
  the kernels' plain versions walking each tile's ranges) against
  composite_image_pallas in interpret mode with the same BucketedBinning
  and its custom VJP: n_buckets 4, bucket_cap 1024, chunk 64, the case of
  tests/test_pallas_grad.py:49. Tolerances: forward atol 3e-5 / rtol 1e-3
  (2e-4 on the LF channels), gradients atol 2e-4 / rtol 2e-2;
* the bucketed render against the flat render through the port's own
  rasterize, at the forward tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.ops import binning as JB
from legslam_tpu.ops.pallas.composite import composite_image_pallas
from legslam_tpu.ops.projection import Preprocessed as JPre
from legslam_tpu.ops.projection import preprocess as jax_preprocess
from legslam_tpu.utils.sh import sh_to_color as jax_sh_to_color
from legslam_tpu.utils.transforms import normalize_quat
from legslam_torch.config import RasterizeConfig
from legslam_torch.ops import binning as TB
from legslam_torch.ops.cuda import composite as CF
from legslam_torch.ops.projection import Preprocessed
from legslam_torch.ops.rasterize import rasterize

from .torch_parity import assert_close, np_, t_, torch_view
from .util import random_scene, simple_view

torch.set_num_threads(1)

W, H = 128, 64
CHUNK = 64
B, CAP = 4, 1024
GRAD_TOL = dict(atol=2e-4, rtol=2e-2)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    scene = random_scene(rng, n=480, capacity=512, lf_dim=64, spread=1.2)
    # wider gaussians: a few tile rows each, so the caps bind and some
    # pixels terminate
    scene["scales"] = scene["scales"] * 3.0
    view = simple_view(width=W, height=H)
    pre = jax_preprocess(
        jnp.asarray(scene["means3d"]), jnp.asarray(scene["scales"]),
        normalize_quat(jnp.asarray(scene["quats"])),
        jnp.asarray(scene["valid"]), view.world_view, view.full_proj, W, H,
        view.focal_x, view.focal_y, view.tan_fovx, view.tan_fovy)
    rgb = jax_sh_to_color(3, jnp.asarray(scene["sh"]),
                          jnp.asarray(scene["means3d"]), view.cam_center)
    feats = jnp.concatenate([rgb, jnp.asarray(scene["lang_feat"]),
                             pre.depth[:, None]], axis=-1)
    c = feats.shape[1]
    return dict(pre={k: np.asarray(v) for k, v in pre._asdict().items()},
                opacity=scene["opacity"], feats=np.asarray(feats),
                scene=scene, view=view,
                cot_img=(rng.normal(size=(H, W, c)) / W).astype(np.float32),
                cot_t=(rng.normal(size=(H, W)) / W).astype(np.float32))


def _pres(inputs):
    pre = inputs["pre"]
    return JPre(**{k: jnp.asarray(v) for k, v in pre.items()}), \
        Preprocessed(**{k: t_(v) for k, v in pre.items()})


def _assert_equal(bt, bj):
    for field in bj._fields:
        np.testing.assert_array_equal(np_(getattr(bt, field)),
                                      np_(getattr(bj, field)),
                                      err_msg=field)


@pytest.mark.parametrize("cull,cap", [(True, CAP), (False, CAP),
                                      (True, 256)])
def test_bucketed_binning_bit_exact(inputs, cull, cap):
    pj, pt = _pres(inputs)
    op = inputs["opacity"]
    kw = dict(chunk=CHUNK, max_span_x=3, max_span_y=8, ellipse_cull=cull)
    bj = JB.bin_gaussians_bucketed(
        pj, W, H, JaxCfg(**kw, backend="pallas"), B, cap,
        opacity=jnp.asarray(op))
    bt = TB.bin_gaussians_bucketed(
        pt, W, H, RasterizeConfig(**kw, backend="cuda", cuda_sort=False),
        B, cap, opacity=t_(op))
    _assert_equal(bt, bj)
    assert int(bt.num_rendered) > 0
    if cap == 256:
        assert int(bt.overflow) > 0
    else:
        assert int(bt.overflow) == 0


def test_ellipse_cull_off_bit_exact(inputs):
    """ellipse_cull=False emits every pair of the opacity-aware rect, in
    the flat binning as in JAX's, and more pairs than the cull."""
    pj, pt = _pres(inputs)
    op = inputs["opacity"]
    out = {}
    for cull in (True, False):
        kw = dict(chunk=CHUNK, max_pairs=1 << 13, ellipse_cull=cull)
        bj = JB.bin_gaussians(pj, W, H, JaxCfg(**kw, backend="pallas"),
                              opacity=jnp.asarray(op))
        bt = TB.bin_gaussians(pt, W, H, RasterizeConfig(**kw, backend="cuda"),
                              opacity=t_(op))
        _assert_equal(bt, bj)
        out[cull] = int(bt.num_rendered)
    assert out[False] > out[True] > 0


def _bucketed(inputs):
    pj, pt = _pres(inputs)
    op = inputs["opacity"]
    kw = dict(chunk=CHUNK, max_span_x=3, max_span_y=8)
    bj = JB.bin_gaussians_bucketed(pj, W, H, JaxCfg(**kw, backend="pallas"),
                                   B, CAP, opacity=jnp.asarray(op))
    bt = TB.BucketedBinning(**{k: t_(v) for k, v in bj._asdict().items()})
    return bj, bt


@pytest.fixture(scope="module")
def pallas_bucketed(inputs):
    """composite_image_pallas (interpret, n_buckets 4) and its VJP."""
    bj, _ = _bucketed(inputs)
    pre = inputs["pre"]
    args = tuple(jnp.asarray(x) for x in (pre["mean2d"], pre["conic"],
                                          inputs["opacity"], inputs["feats"]))

    def f(*a):
        return composite_image_pallas(bj, *a, W, H, 128, 16, 1 << 12,
                                      CHUNK, interpret=True,
                                      differentiable=True, n_buckets=B)
    (img, tf), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(inputs["cot_img"]),
                 jnp.asarray(inputs["cot_t"])))
    return np.asarray(img), np.asarray(tf), [np.asarray(g) for g in grads]


def _port_bucketed(inputs):
    _, bt = _bucketed(inputs)
    pre = inputs["pre"]
    leaves = [t_(x).requires_grad_(True) for x in
              (pre["mean2d"], pre["conic"], inputs["opacity"],
               inputs["feats"])]
    img, tf, kfin = CF.composite_image(bt, *leaves, W, H, 128, 16, 1 << 12,
                                       CHUNK, "float32", n_buckets=B)
    loss = (img * t_(inputs["cot_img"])).sum() + \
        (tf * t_(inputs["cot_t"])).sum()
    loss.backward()
    return img.detach(), tf.detach(), kfin, [x.grad for x in leaves]


def test_bucketed_forward_matches_pallas(inputs, pallas_bucketed):
    img, tf, kfin, _ = _port_bucketed(inputs)
    jimg, jtf, _ = pallas_bucketed
    assert kfin is None  # the watermark is the flat layout's
    assert_close(img[..., :3], jimg[..., :3], 3e-5, 1e-3, "rgb")
    assert_close(img[..., -1], jimg[..., -1], 3e-5, 1e-3, "depth")
    assert_close(img[..., 3:-1], jimg[..., 3:-1], 2e-4, 1e-3, "lf")
    assert_close(tf, jtf, 3e-5, 1e-3, "t_final")
    assert float(tf.min()) < 0.5


def test_bucketed_backward_matches_pallas(inputs, pallas_bucketed):
    """Pair gradients through the scatter-add (the sentinel holes of the
    bucketed buffer dropped onto spare rows) against the Pallas VJP. The
    conic gradient takes test_torch_composite's allowance (the Pallas
    kernel's global-coordinate moments cancel in f32): atol 1e-3 x its
    largest value."""
    *_, grads = _port_bucketed(inputs)
    for g, jg, name in zip(grads, pallas_bucketed[2],
                           ("mean2d", "conic", "opacity", "feats")):
        assert np.isfinite(np_(g)).all(), name
        assert np.abs(jg).max() > 1e-4, name
        tol = dict(GRAD_TOL, atol=1e-3 * np.abs(jg).max()) \
            if name == "conic" else GRAD_TOL
        assert_close(g, jg, err_msg=name, **tol)


def test_bucketed_plain_versions_walk_ranges_in_order(inputs):
    """The plain forward and backward on a bucketed layout equal the same
    pairs laid out flat (each tile's buckets concatenated), up to the
    summation order of the chunks."""
    _, bt = _bucketed(inputs)
    pre = inputs["pre"]
    start, count, geo, pf = CF.prepare_pairs(
        bt, t_(pre["mean2d"]), t_(pre["conic"]), t_(inputs["opacity"]),
        t_(inputs["feats"]), 1 << 12, n_buckets=B)
    ntx = -(-W // 128)
    # the flat layout of the same pairs: per tile, its ranges in order
    rows, fstart, fcount = [], [], []
    n = 0
    for t in range(start.shape[0] // B):
        fstart.append(n)
        for b in range(B):
            s, c = int(start[t * B + b]), int(count[t * B + b])
            rows.append(torch.arange(s, s + c))
            n += c
        fcount.append(n - fstart[-1])
    rows = torch.cat(rows)
    fs = torch.tensor(fstart, dtype=torch.int32)
    fc = torch.tensor(fcount, dtype=torch.int32)
    acc_b, tf_b, _ = CF.composite_forward_plain(start, count, geo, pf, 128,
                                                16, ntx, CHUNK, B)
    acc_f, tf_f, _ = CF.composite_forward_plain(fs, fc, geo[rows], pf[rows],
                                                128, 16, ntx, CHUNK)
    assert_close(acc_b, acc_f, 3e-5, 1e-3, "acc")
    assert_close(tf_b, tf_f, 3e-5, 1e-3, "t_final")
    from legslam_torch.ops.cuda import composite_bwd as CB
    rng = np.random.default_rng(0)
    gout = t_(rng.normal(size=acc_b.shape).astype(np.float32) / W)
    gt = t_(rng.normal(size=tf_b.shape).astype(np.float32) / W)
    dg_b, df_b = CB.composite_backward_plain(start, count, geo, pf, gout, gt,
                                             tf_b, acc_b, 128, 16, ntx,
                                             CHUNK, B)
    dg_f, df_f = CB.composite_backward_plain(fs, fc, geo[rows], pf[rows],
                                             gout, gt, tf_f, acc_f, 128, 16,
                                             ntx, CHUNK)
    assert_close(dg_b[rows], dg_f, 2e-4 * float(dg_f.abs().max()), 2e-2,
                 "dgeo")
    assert_close(df_b[rows], df_f, 2e-4 * float(df_f.abs().max()), 2e-2,
                 "dfeats")
    # nothing outside the ranges gets a gradient
    outside = torch.ones(geo.shape[0], dtype=torch.bool)
    outside[rows] = False
    assert float(dg_b[outside].abs().max()) == 0.0


def test_bucketed_render_matches_flat(inputs):
    """The port's rasterize with n_buckets 4 equals the flat render."""
    sc = inputs["scene"]
    view = torch_view(inputs["view"])
    args = (t_(sc["means3d"]), t_(sc["sh"]), t_(sc["lang_feat"]),
            t_(sc["opacity"]), t_(sc["scales"]), t_(sc["quats"]),
            t_(sc["valid"]), view, torch.tensor([0.1, 0.2, 0.3]), 3)
    flat = RasterizeConfig(chunk=CHUNK, max_pairs=1 << 13, backend="cuda",
                           max_span_x=3, max_span_y=8)
    outs = [rasterize(*args, cfg=c) for c in
            (flat, dataclasses.replace(flat, n_buckets=B, bucket_cap=CAP))]
    for name in ("color", "depth", "final_t"):
        assert_close(getattr(outs[1], name), getattr(outs[0], name), 3e-5,
                     1e-3, name)
    assert_close(outs[1].lang_feat, outs[0].lang_feat, 2e-4, 1e-3, "lf")
    assert int(outs[1].overflow_pairs) == int(outs[0].overflow_pairs) == 0
    assert int(outs[1].num_rendered) == int(outs[0].num_rendered)
