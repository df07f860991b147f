"""legslam_torch's sort wrappers (their plain versions on the CPU) against
legslam_tpu's Pallas bitonic sorts run in interpret mode, at the sizes of
tests/test_pallas_sort.py. Keys and values must match exactly. The Pallas
network leaves tied keys in no fixed order, so the kv and argsort cases
use distinct keys (asserted); for argsort the valid prefix must match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.ops.pallas import sort as JS
from legslam_torch.ops.cuda import sort as TS

from .torch_parity import np_, t_


def test_sort_keys_matches_pallas():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, 1 << 12).astype(np.int32)
    keys[::7] = keys[3]                # ties sort the same in any order
    got = TS.sort_keys(t_(keys))
    want = JS.sort_keys(jnp.asarray(keys), interpret=True)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_sort_kv_matches_pallas():
    rng = np.random.default_rng(1)
    n = 1 << 11
    keys = rng.permutation(n).astype(np.int32)
    vals = rng.integers(0, 1 << 20, n).astype(np.int32)
    ok_t, ov_t = TS.sort_kv(t_(keys), t_(vals))
    ok_j, ov_j = JS.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                            interpret=True)
    np.testing.assert_array_equal(np_(ok_t), np.asarray(ok_j))
    np.testing.assert_array_equal(np_(ov_t), np.asarray(ov_j))


@pytest.mark.parametrize("n", [3000, 1 << 11])
def test_argsort_f32_matches_pallas(n):
    rng = np.random.default_rng(n)
    keys = rng.uniform(0.1, 100.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    nv = int(valid.sum())
    assert np.unique(keys[valid]).size == nv
    got = np_(TS.argsort_f32(t_(keys), t_(valid)))
    want = np.asarray(JS.argsort_f32(jnp.asarray(keys), jnp.asarray(valid),
                                     interpret=True))
    assert got.shape == want.shape == (TS.padded_length(n, 256),)
    np.testing.assert_array_equal(got[:nv], want[:nv])
    # the invalid and padded entries follow, in index order here
    assert np.all(np.diff(got[nv:]) > 0)
    assert set(got[nv:]) == set(want[nv:])


def test_argsort_bits_are_the_pallas_transform():
    """invalid -> FLT_MAX, bit-cast, INT32_MAX padding (sort.py:177-192)."""
    keys = np.array([0.0, 1.5, 2.0e30, 7.25, 3.0], np.float32)
    valid = np.array([True, False, True, True, False])
    bits = np_(TS.argsort_bits(t_(keys), t_(valid)))
    k = np.where(valid, keys, np.finfo(np.float32).max).astype(np.float32)
    assert bits.shape == (256,)
    np.testing.assert_array_equal(bits[:5], k.view(np.int32))
    assert np.all(bits[5:] == np.iinfo(np.int32).max)
    assert torch.equal(TS.argsort_f32(t_(keys), t_(valid))[:3],
                       torch.tensor([0, 3, 2], dtype=torch.int32))
