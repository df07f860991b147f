"""legslam_torch.models.lpips against the JAX package on shared
init_params weights at 64x64 (single and batched), the metric's
properties (zero for identical images, symmetric, positive, monotone), the
AlexNet tap shapes, and the .npz weight file both packages read."""
import numpy as np
import pytest
import torch

from legslam_torch.models import lpips as TL
from legslam_tpu.models import lpips as JL
from tests.torch_parity import np_

torch.set_num_threads(1)

H = W = 64


@pytest.fixture(scope="module")
def weights():
    tree = TL.init_params(np.random.default_rng(3))
    return tree, TL.params_from_numpy(tree, "cpu")


def test_init_params_is_jax_init_params():
    a = TL.init_params(np.random.default_rng(3))
    b = JL.init_params(np.random.default_rng(3))
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k])


def test_lpips_matches_jax(weights):
    """Single [64, 64, 3] and batched [2, 64, 64, 3]: within rtol 1e-4 of
    JAX (measured 1.9e-7 relative; NHWC/HWIO against NCHW/OIHW
    convolutions)."""
    tree, params = weights
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    b = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    want = np.asarray(JL.lpips(tree, a, b))
    got = np_(TL.lpips(params, a, b))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    one = TL.lpips(params, a[0], b[0])
    assert one.shape == ()
    np.testing.assert_allclose(float(one), float(JL.lpips(tree, a[0], b[0])),
                               rtol=1e-4)
    np.testing.assert_allclose(float(one), got[0], rtol=1e-5)


def test_zero_symmetric_positive_monotone(weights):
    _, params = weights
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 0.8, size=(H, W, 3)).astype(np.float32)
    b = rng.uniform(size=(H, W, 3)).astype(np.float32)
    assert float(TL.lpips(params, a, a)) == pytest.approx(0.0, abs=1e-6)
    dab = float(TL.lpips(params, a, b))
    assert dab > 0
    assert dab == pytest.approx(float(TL.lpips(params, b, a)), rel=1e-5)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    small = float(TL.lpips(params, a, np.clip(a + 0.02 * n, 0, 1)))
    large = float(TL.lpips(params, a, np.clip(a + 0.3 * n, 0, 1)))
    assert large > small > 0


def test_feature_shapes(weights):
    """torchvision AlexNet's tap shapes for a 224x224 input."""
    _, params = weights
    feats = TL.alex_features(params, torch.zeros(1, 3, 224, 224))
    assert [tuple(f.shape) for f in feats] == [
        (1, 64, 55, 55), (1, 192, 27, 27), (1, 384, 13, 13),
        (1, 256, 13, 13), (1, 256, 13, 13)]


def test_load_params_reads_the_jax_file(tmp_path, weights):
    """An lpips_alex.npz in the JAX layout: load_params transposes the
    kernels to OIHW, and the metric equals the in-memory weights'."""
    tree, params = weights
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **tree)
    loaded = TL.load_params(path, device="cpu")
    assert sorted(loaded) == sorted(params)
    for k in params:
        assert torch.equal(loaded[k], params[k])
    assert tuple(loaded["conv0/w"].shape) == (64, 3, 11, 11)
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(H, W, 3)).astype(np.float32) for _ in range(2))
    assert float(TL.lpips(loaded, a, b)) == float(TL.lpips(params, a, b))
