"""legslam_torch compositing vs legslam_tpu.

* the "cuda" backend's path (prepare_pairs + the forward/backward kernels'
  plain versions, which the wrappers run on CPU tensors) against
  composite_image_pallas in interpret mode and its custom VJP, in float32
  and bfloat16 pair features, kfin included;
* the "torch" reference compositor against the JAX "xla" compositor.

The kernels against their plain versions on a card are in
tests/test_torch_kernels.py, which imports no JAX.

Tolerances are the JAX suite's: forward atol 3e-5 / rtol 1e-3 and 2e-4 for
the language features (tests/test_pallas_composite.py), gradients atol
2e-4 / rtol 2e-2 (tests/test_pallas_grad.py), bf16 color error < 2e-2 and
gradient cosine > 0.999 (tests/test_mm_dtype.py); kfin bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.config import RasterizeConfig as JaxCfg
from legslam_tpu.ops import rasterize as JR
from legslam_tpu.ops.binning import bin_gaussians as jax_bin
from legslam_tpu.ops.pallas.composite import composite_image_pallas
from legslam_tpu.ops.projection import preprocess as jax_preprocess
from legslam_tpu.utils.sh import sh_to_color as jax_sh_to_color
from legslam_tpu.utils.transforms import normalize_quat
from legslam_torch.config import RasterizeConfig
from legslam_torch.ops import rasterize as TR
from legslam_torch.ops.binning import Binning
from legslam_torch.ops.cuda import composite as CF
from legslam_torch.ops.cuda import composite_bwd as CB

from .torch_parity import assert_close, np_, t_
from .util import random_scene, simple_view

torch.set_num_threads(1)

W, H = 128, 64
CHUNK = 64
MAX_PAIRS = 2048
GRAD_TOL = dict(atol=2e-4, rtol=2e-2)


@pytest.fixture(scope="module")
def inputs():
    """Per-gaussian compositing inputs (computed once by the JAX prologue),
    a flat binning with the opacity cull, and seeded cotangents."""
    rng = np.random.default_rng(3)
    scene = random_scene(rng, n=300, capacity=384, lf_dim=64)
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
    op = jnp.asarray(scene["opacity"])
    c = feats.shape[1]
    return dict(mean2d=np.asarray(pre.mean2d), conic=np.asarray(pre.conic),
                opacity=np.asarray(op), feats=np.asarray(feats),
                pre=pre, binning=jax_bin(pre, W, H, JaxCfg(
                    chunk=CHUNK, max_pairs=MAX_PAIRS, backend="pallas"),
                    opacity=op),
                # mean-loss-sized cotangents, as the JAX suite's losses
                cot_img=(rng.normal(size=(H, W, c)) / W).astype(np.float32),
                cot_t=(rng.normal(size=(H, W)) / W).astype(np.float32))


def _args(inp):
    return tuple(jnp.asarray(inp[k]) for k in
                 ("mean2d", "conic", "opacity", "feats"))


@pytest.fixture(scope="module")
def jax_pallas(inputs):
    """composite_image_pallas (interpret) outputs, kfin and VJP, per
    mm_dtype."""
    out = {}
    for mm in ("float32", "bfloat16"):
        def f(*a):
            img, tf, kfin = composite_image_pallas(
                inputs["binning"], *a, W, H, 128, 16, MAX_PAIRS, CHUNK,
                interpret=True, differentiable=True, mm_dtype=mm,
                emit_kfin=True)
            return (img, tf), kfin
        (img, tf), vjp, kfin = jax.vjp(f, *_args(inputs), has_aux=True)
        grads = vjp((jnp.asarray(inputs["cot_img"]),
                     jnp.asarray(inputs["cot_t"])))
        out[mm] = (np.asarray(img), np.asarray(tf), np.asarray(kfin),
                   [np.asarray(g) for g in grads])
    return out


def _torch_binning(jb):
    return Binning(**{k: t_(v) for k, v in jb._asdict().items()})


def _port_composite(inputs, mm_dtype):
    leaves = [t_(inputs[k]).requires_grad_(True) for k in
              ("mean2d", "conic", "opacity", "feats")]
    img, tf, kfin = CF.composite_image(
        _torch_binning(inputs["binning"]), *leaves, W, H, 128, 16,
        MAX_PAIRS, CHUNK, mm_dtype)
    loss = (img * t_(inputs["cot_img"])).sum() + \
        (tf * t_(inputs["cot_t"])).sum()
    loss.backward()
    return img.detach(), tf.detach(), kfin, [x.grad for x in leaves]


def test_forward_matches_pallas_kernel(inputs, jax_pallas):
    img, tf, kfin, _ = _port_composite(inputs, "float32")
    jimg, jtf, jkfin, _ = jax_pallas["float32"]
    assert_close(img[..., :3], jimg[..., :3], 3e-5, 1e-3, "rgb")
    assert_close(img[..., -1], jimg[..., -1], 3e-5, 1e-3, "depth")
    assert_close(img[..., 3:-1], jimg[..., 3:-1], 2e-4, 1e-3, "lf")
    assert_close(tf, jtf, 3e-5, 1e-3, "t_final")
    np.testing.assert_array_equal(np_(kfin), jkfin)
    assert 0 < int(kfin.max())


def _xla_vjp(inputs):
    """The JAX "xla" compositor's autodiff gradients (the oracle of the
    Pallas kernels) for the fixture's cotangents."""
    jcfg = JaxCfg(chunk=CHUNK, tile_batch=4, backend="xla")
    jb = jax_bin(inputs["pre"], W, H, jcfg, opacity=_args(inputs)[2])

    def jf(*a):
        img, tf = JR._composite_tiles(jb, *a, W, H, jcfg, 512)
        return jnp.sum(img * inputs["cot_img"]) + \
            jnp.sum(tf * inputs["cot_t"]), (img, tf)
    (_, out), grads = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(*_args(inputs))
    return jb, out, grads


def test_backward_matches_pallas_vjp(inputs, jax_pallas):
    """Pair-level gradients (through the scatter-add onto the gaussians)
    against the Pallas VJP and the xla autodiff oracle, GRAD_TOL. One
    allowance: the Pallas kernel forms the conic moments in global pixel
    coordinates, gx^2 m0 - 2 gx mx + mxx (composite_bwd.py:302-304), and
    that f32 cancellation leaves it an absolute error of order
    eps * W^2 * |m0|; the port sums in pair-centered coordinates. Its conic
    gradient is held to the oracle at GRAD_TOL and to the Pallas VJP at an
    atol of 1e-3 x the largest conic gradient."""
    *_, grads = _port_composite(inputs, "float32")
    oracle = _xla_vjp(inputs)[2]
    for g, jg, og, name in zip(grads, jax_pallas["float32"][3], oracle,
                               ("mean2d", "conic", "opacity", "feats")):
        assert np.isfinite(np_(g)).all(), name
        assert np.abs(jg).max() > 1e-3, name
        assert_close(g, og, err_msg=name + " vs xla", **GRAD_TOL)
        tol = dict(GRAD_TOL, atol=1e-3 * np.abs(jg).max()) \
            if name == "conic" else GRAD_TOL
        assert_close(g, jg, err_msg=name + " vs pallas", **tol)


def test_bf16_features_match_pallas_bf16(inputs, jax_pallas):
    img, tf, kfin, grads = _port_composite(inputs, "bfloat16")
    jimg, jtf, jkfin, jgrads = jax_pallas["bfloat16"]
    assert np.abs(np_(img[..., :3]) - jimg[..., :3]).max() < 2e-2
    # transmittance carries no bf16 rounding on either side
    assert_close(tf, jax_pallas["float32"][1], 3e-5, 1e-3, "t_final")
    np.testing.assert_array_equal(np_(kfin), jkfin)
    for g, jg in zip(grads, jgrads):
        a, b = np_(g).astype(np.float64).ravel(), jg.astype(np.float64).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        assert cos > 0.999, cos


def test_reference_compositor_matches_xla(inputs):
    """The "torch" backend's compositor vs the JAX "xla" one (the oracle
    of both packages' kernels), values and gradients."""
    tcfg = RasterizeConfig(chunk=CHUNK, tile_batch=4, backend="torch")
    jb, (jimg, jtf), jgrads = _xla_vjp(inputs)
    cot_img, cot_t = inputs["cot_img"], inputs["cot_t"]
    leaves = [t_(inputs[k]).requires_grad_(True) for k in
              ("mean2d", "conic", "opacity", "feats")]
    img, tf = TR._composite_tiles(_torch_binning(jb), *leaves, W, H, tcfg,
                                  512)
    ((img * t_(cot_img)).sum() + (tf * t_(cot_t)).sum()).backward()
    assert_close(img.detach(), jimg, 2e-5, 1e-4, "img")
    assert_close(tf.detach(), jtf, 2e-5, 1e-4, "t_final")
    for g, jg, name in zip(leaves, jgrads,
                           ("mean2d", "conic", "opacity", "feats")):
        assert_close(g.grad, jg, err_msg=name, **GRAD_TOL)


def test_wrappers_reject_bad_inputs(inputs):
    start = torch.zeros(4, dtype=torch.int32)
    geo = torch.zeros(16, 8)
    feats = torch.zeros(16, 8)
    with pytest.raises(TypeError):
        CF.composite_forward(start.long(), start, geo, feats, 128, 16, 1, 64)
    with pytest.raises(ValueError):
        CF.composite_forward(start, start, geo[:, :6], feats, 128, 16, 1, 64)
    with pytest.raises(ValueError):
        CF.composite_forward(start, start, geo, feats, 128, 16, 1, 48)
    acc, tfin, kfin = CF.composite_forward(start, start, geo, feats, 128, 16,
                                           1, 64)
    assert (tfin == 1).all() and (acc == 0).all() and (kfin == 0).all()
    with pytest.raises(ValueError):
        CB.composite_backward(start, start, geo, feats, acc[:, :7], tfin,
                              tfin, acc, 128, 16, 1, 64)
