"""legslam_torch.models.pamr against the JAX package: the default
dilations (1-24; 24 is larger than half of the 48-pixel side, so the edge
padding reaches past the image) and 10 iterations on a 48x80 image with
2 masks, and the two behaviour tests of tests/test_pamr.py."""
import jax.numpy as jnp
import numpy as np
import torch

from legslam_torch.models.pamr import pamr
from legslam_tpu.models.pamr import pamr as jax_pamr
from tests.torch_parity import np_

torch.set_num_threads(1)


def test_pamr_matches_jax_at_defaults():
    """Blocky image + noisy soft masks: within atol 1e-5 of JAX on masks
    in [0, 1] (measured 6.6e-7: the 48-neighbour sums and the softmax
    round apart)."""
    rng = np.random.default_rng(0)
    img = np.zeros((48, 80, 3), np.float32)
    img[:, 40:] = [0.9, 0.2, 0.1]
    img[10:30, 5:25] = [0.1, 0.8, 0.3]
    img += rng.normal(scale=0.05, size=img.shape).astype(np.float32)
    masks = rng.uniform(size=(48, 80, 2)).astype(np.float32)
    want = np.asarray(jax_pamr(jnp.asarray(img), jnp.asarray(masks)))
    got = np_(pamr(torch.as_tensor(img), torch.as_tensor(masks)))
    assert got.shape == (48, 80, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pamr_shift_past_the_image():
    """A dilation larger than the image (here 24 on a 16x20 image) reads
    the edge pixel, as JAX's edge-padded shift does."""
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(16, 20, 3)).astype(np.float32)
    masks = rng.uniform(size=(16, 20, 1)).astype(np.float32)
    want = np.asarray(jax_pamr(jnp.asarray(img), jnp.asarray(masks),
                               iterations=3, dilations=(24,)))
    got = np_(pamr(img, masks, iterations=3, dilations=(24,)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_pamr_respects_edges():
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 16:] = 1.0
    mask = np.zeros((32, 32, 2), np.float32)
    mask[:, :14, 0] = 1.0
    mask[:, 18:, 1] = 1.0
    out = np_(pamr(torch.as_tensor(img), torch.as_tensor(mask),
                   iterations=10, dilations=(1, 2, 4)))
    assert out[:, :16, 0].mean() > out[:, :16, 1].mean()
    assert out[:, 16:, 1].mean() > out[:, 16:, 0].mean()
    assert np.isfinite(out).all()


def test_pamr_preserves_uniform_mask():
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)) \
        .astype(np.float32)
    mask = np.ones((16, 16, 1), np.float32)
    out = np_(pamr(torch.as_tensor(img), torch.as_tensor(mask),
                   iterations=5, dilations=(1, 2)))
    np.testing.assert_allclose(out, 1.0, rtol=1e-5)
