"""legslam_torch losses vs legslam_tpu: values and gradients on the same
seeded images. Tolerances: values rtol 1e-5 (f32 reductions in another
order), gradients atol 1e-6 x the largest reference gradient / rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.ops import losses as JL
from legslam_torch.ops import losses as TL

from .torch_parity import assert_close, t_

torch.set_num_threads(1)

H, W = 40, 56


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    f = np.float32
    mask = (rng.uniform(size=(H, W)) > 0.2).astype(f)
    lf_pred = rng.normal(size=(H, W, 64)).astype(f)
    lf_pred[:3, :3] = 0.0   # exactly zero rendered LF, the clamp branch
    return dict(
        color=rng.uniform(size=(H, W, 3)).astype(f),
        gt_color=rng.uniform(size=(H, W, 3)).astype(f),
        lf=lf_pred, gt_lf=rng.normal(size=(H, W, 64)).astype(f),
        depth=rng.uniform(0.5, 5, size=(H, W)).astype(f),
        gt_depth=rng.uniform(0.5, 5, size=(H, W)).astype(f),
        mask=mask)


def _grad_close(g, jg, name):
    jg = np.asarray(jg)
    assert_close(g, jg, 1e-6 * np.abs(jg).max(), 1e-4, name)


def test_simple_losses_match(images):
    a, b, m = images["color"], images["gt_color"], images["mask"][..., None]
    for name, args in (("l1_loss", (a, b)), ("psnr", (a, b)),
                       ("masked_l1_loss", (a, b, m)),
                       ("lf_cosine_similarity", (images["lf"],
                                                 images["gt_lf"]))):
        tv = getattr(TL, name)(*map(t_, args))
        jv = getattr(JL, name)(*map(jnp.asarray, args))
        assert_close(tv, jv, 1e-6, 1e-5, name)


def test_psnr_gaussian_splatting_matches(images):
    """The per-channel PSNR of record_keyframe_metrics (loss_utils.h:46)."""
    a, b = images["color"], images["gt_color"]
    assert_close(TL.psnr_gaussian_splatting(t_(a), t_(b)),
                 JL.psnr_gaussian_splatting(jnp.asarray(a), jnp.asarray(b)),
                 1e-6, 1e-5, "psnr_gaussian_splatting")


@pytest.mark.parametrize("which", ["ssim", "lf_cos", "mapping_loss"])
def test_loss_values_and_grads_match(images, which):
    im = images
    if which == "ssim":
        args = (im["color"], im["gt_color"])
        jf, tf = JL.ssim, TL.ssim
    elif which == "lf_cos":
        args = (im["lf"], im["gt_lf"])

        def jf(p, g):
            return JL._lf_cos_masked(p, g, jnp.asarray(im["mask"]), 1e-8)

        def tf(p, g):
            return TL._lf_cos_masked(p, g, t_(im["mask"]), 1e-8)
    else:
        args = (im["color"], im["lf"], im["depth"])

        def jf(c, lf, d):
            return JL.mapping_loss(c, jnp.asarray(im["gt_color"]), lf,
                                   jnp.asarray(im["gt_lf"]), d,
                                   jnp.asarray(im["gt_depth"]),
                                   jnp.asarray(im["mask"]), 0.2)

        def tf(c, lf, d):
            return TL.mapping_loss(c, t_(im["gt_color"]), lf, t_(im["gt_lf"]),
                                   d, t_(im["gt_depth"]), t_(im["mask"]), 0.2)
    jv, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [t_(a).requires_grad_(True) for a in args]
    tv = tf(*leaves)
    tv.backward()
    assert_close(tv.detach(), jv, 1e-6, 1e-5, which)
    for i, (leaf, jg) in enumerate(zip(leaves, jgrads)):
        assert torch.isfinite(leaf.grad).all()
        _grad_close(leaf.grad, jg, f"{which} d arg {i}")


def test_blur_is_banded_zero_padded_conv():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(23, 31, 2)).astype(np.float32)
    assert_close(TL._blur(t_(img)), JL._blur(jnp.asarray(img)), 1e-6, 1e-5)
