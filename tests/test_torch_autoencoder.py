"""legslam_torch.models.autoencoder against the JAX package: encode /
decode on weights carried across from the JAX init, and the Adam training
reconstructing a low-rank feature corpus (seeded, reproducible)."""
import jax
import numpy as np
import torch

from legslam_torch.models import autoencoder as TA
from legslam_tpu.models import autoencoder as JA
from tests.torch_parity import np_

torch.set_num_threads(1)


def test_encode_decode_match_jax():
    """JAX's init (d 96, k 8) carried across: encode and decode within
    atol 1e-5 of JAX (measured 4.8e-7)."""
    jp = JA.AEParams(*(np.asarray(a) for a in
                       JA.init(jax.random.key(0), d=96, k=8)))
    tp = TA.params_from_numpy(jp, "cpu")
    x = np.random.default_rng(0).normal(size=(50, 96)).astype(np.float32)
    z_j = np.asarray(JA.encode(jp, x))
    z_t = TA.encode(tp, torch.as_tensor(x))
    np.testing.assert_allclose(np_(z_t), z_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(TA.decode(tp, z_t)),
                               np.asarray(JA.decode(jp, z_j)),
                               atol=1e-5, rtol=0)


def test_training_reconstructs():
    """A rank-8 corpus in 96-D: 40 epochs of Adam (lr 1e-2) take the
    reconstruction MSE below 5% of the data's variance, from 100% at the
    untrained init; the same seed gives the same weights."""
    rng = np.random.default_rng(1)
    basis = rng.normal(size=(8, 96)).astype(np.float32)
    data = (rng.normal(size=(512, 8)) @ basis).astype(np.float32)
    batches = np.split(data, 4)
    var = float(((data - data.mean(0)) ** 2).mean())

    def fit():
        return TA.train_autoencoder(batches, torch.Generator().manual_seed(2),
                                    d=96, k=8, lr=1e-2, epochs=40,
                                    device="cpu")
    p = fit()
    x = torch.as_tensor(data)
    mse = float(((TA.decode(p, TA.encode(p, x)) - x) ** 2).mean())
    p0 = TA.init(torch.Generator().manual_seed(2), 96, 8, device="cpu")
    mse0 = float(((TA.decode(p0, TA.encode(p0, x)) - x) ** 2).mean())
    assert mse0 > 0.5 * var
    assert mse < 0.05 * var, (mse, var)
    assert all(torch.equal(a, b) for a, b in zip(p, fit()))
