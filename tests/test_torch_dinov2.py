"""legslam_torch.models.dinov2 against the JAX package's DINOv2, on the
CPU: the same seeded numpy parameters and images through both forwards.

Tolerances:
* float32: atol 2e-4 / rtol 1e-3 against JAX and against the stored
  goldens of the small fixture (tests/test_golden_fixtures.py); the
  full-size fixture (width 768, 12 heads, 2 blocks) atol 5e-4 / rtol 2e-3
  at 518x518 and at 588x546 (its rectangular 42x39 grid interpolates the
  positional embedding), as the JAX suite holds JAX to them;
* bfloat16 mode (bf16 weights and patch convolution, float32 arithmetic
  in both packages): atol 2e-5 / rtol 1e-5 on tokens of magnitude ~4
  (measured: 1.2e-6), far inside the repo's bf16 gate (color error under
  2e-2, tests/test_mm_dtype.py);
* interpolate_pos_embed: 1e-5 (measured 9.5e-7 for 37 -> 42x39).
The converters are held in tests/test_torch_dinov2_convert.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_torch.models import dinov2 as TD
from legslam_torch.models.weights_io import unflatten
from legslam_tpu.models import dinov2 as JD

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = dict(image_size=56, patch_size=14, dim=64, depth=2, heads=2,
             num_registers=4, pos_grid=4)


def _fixture(name):
    with np.load(os.path.join(FIXTURES, f"{name}.npz")) as z:
        params = unflatten({k[len("param:"):].replace(".", "/"): z[k]
                            for k in z.files if k.startswith("param:")})
        rest = {k: z[k] for k in z.files if not k.startswith("param:")}
    return params, rest


@pytest.fixture(scope="module")
def small_params():
    """Seeded small-config parameters, with every LayerScale, bias and
    norm perturbed so that no block is close to the identity."""
    rng = np.random.default_rng(3)
    jp = JD.init_params(JD.DinoV2Config(**SMALL), jax.random.key(0))
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1)
        .astype(np.float32), jp)


def _both(tree, images, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(JD.forward(tree, images, JD.DinoV2Config(**SMALL),
                                 dtype=jd))
    got = TD.forward(TD.params_from_numpy(tree, "cpu"),
                     torch.as_tensor(images), TD.DinoV2Config(**SMALL),
                     dtype=td).numpy()
    return got, want


@pytest.mark.parametrize("shape", [(2, 56, 56, 3), (1, 70, 84, 3)])
def test_forward_matches_jax_f32(small_params, shape):
    img = np.random.default_rng(1).uniform(-1, 1, size=shape) \
        .astype(np.float32)
    got, want = _both(small_params, img, "float32")
    assert got.shape == want.shape == (shape[0], (shape[1] // 14) *
                                       (shape[2] // 14), 64)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", [(2, 56, 56, 3), (1, 70, 84, 3)])
def test_forward_matches_jax_bf16(small_params, shape):
    img = np.random.default_rng(2).uniform(-1, 1, size=shape) \
        .astype(np.float32)
    got, want = _both(small_params, img, "bfloat16")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # the mode is not a no-op: float32 differs by far more
    got32, _ = _both(small_params, img, "float32")
    assert np.abs(got32 - want).max() > 1e-3


def test_small_golden():
    params, rest = _fixture("golden_dinov2")
    got = TD.forward(TD.params_from_numpy(params, "cpu"),
                     torch.as_tensor(rest["input:images"]),
                     TD.DinoV2Config(**SMALL)).numpy()
    np.testing.assert_allclose(got, rest["golden:patchtokens"], atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("which,grid", [("", (37, 37)), ("_rect", (42, 39))])
def test_fullsize_golden(which, grid):
    params, rest = _fixture("golden_dinov2_fullsize")
    got = TD.forward(TD.params_from_numpy(params, "cpu"),
                     torch.as_tensor(rest[f"input:images{which}"]),
                     TD.DinoV2Config(depth=2)).numpy()
    assert got.shape == (1, grid[0] * grid[1], 768)
    np.testing.assert_allclose(got, rest[f"golden:patchtokens{which}"],
                               atol=5e-4, rtol=2e-3)


@pytest.mark.parametrize("native,gh,gw,d", [(37, 42, 39, 768),
                                            (4, 5, 5, 64)])
def test_interpolate_pos_embed_matches_jax(native, gh, gw, d):
    pe = np.random.default_rng(4).normal(
        size=(1, native * native + 1, d)).astype(np.float32)
    want = np.asarray(JD.interpolate_pos_embed(jnp.asarray(pe), gh, native,
                                               gw))
    got = TD.interpolate_pos_embed(torch.as_tensor(pe), gh, native,
                                   gw).numpy()
    assert got.shape == want.shape == (1, gh * gw + 1, d)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the native grid is the identity
    same = TD.interpolate_pos_embed(torch.as_tensor(pe), native, native)
    assert np.array_equal(same.numpy(), pe)
