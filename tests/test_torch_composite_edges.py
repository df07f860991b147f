"""The forward compositor's plain version against the Pallas forward kernel
(composite_tiles_pallas in interpret mode) on the hand-placed edge scene of
tests/test_torch_kernels.py (_edge_pairs): a ragged tile past the image
edge, two empty tiles, a tile whose every pixel terminates on its 4th pair
mid-batch, ragged batches, a pair only the first 16x16 block composites.

Both sides get the same numpy pair arrays: the port [N, 8] geometry rows,
Pallas their transpose [8, N], both padded with zero pairs to whole chunks.
Features are float32, and bf16-rounded values (the port's bf16 storage,
given to Pallas as float32, so both sum the same values in f32).
Tolerances: the JAX suite's forward tolerance (tests/test_pallas_composite.py),
acc and t_final atol 3e-5 / rtol 1e-3, 2e-4 on the 64 language-feature
channels; kfin bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.ops.pallas.composite import composite_tiles_pallas
from legslam_torch.ops.cuda import composite as CF

from .test_torch_kernels import _edge_pairs
from .torch_parity import np_

torch.set_num_threads(1)


@pytest.mark.parametrize("nch", [72, 8])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_edge_scene_forward_matches_pallas(mm_dtype, nch):
    ba, _ = _edge_pairs("cpu", mm_dtype, nch)
    start, count, geo, feats = ba[:4]
    tile_w, tile_h, ntx, chunk = ba[8:]
    acc, tfin, kfin = CF.composite_forward(*ba[:4], *ba[8:])
    n = geo.shape[0]
    pad = -(-n // chunk) * chunk + chunk - n
    geo_rows = np.pad(np_(geo), ((0, pad), (0, 0))).T
    feats_np = np.pad(np_(feats.float()), ((0, pad), (0, 0)))
    j_acc, j_tfin, j_kfin = composite_tiles_pallas(
        jnp.asarray(np_(start)), jnp.asarray(np_(count)),
        jnp.asarray(geo_rows), jnp.asarray(feats_np), tile_w=tile_w,
        tile_h=tile_h, ntx=ntx, ntiles=start.shape[0], chunk=chunk,
        interpret=True, emit_kfin=True)
    atol = np.full(nch, 3e-5)
    atol[3:67] = 2e-4
    err = np.abs(np_(acc) - np.asarray(j_acc))
    assert np.all(err <= atol + 1e-3 * np.abs(np.asarray(j_acc))), \
        f"acc max|err| {err.max()}"
    np.testing.assert_allclose(np_(tfin), np.asarray(j_tfin)[..., 0],
                               atol=3e-5, rtol=1e-3)
    np.testing.assert_array_equal(np_(kfin), np.asarray(j_kfin)[:, 0, 0])
    # the scene reaches what it was placed for: empty tiles at the
    # background, a tile that ends dark, chunks counted past the first
    assert np.all(np_(tfin)[[2, 5]] == 1) and np_(tfin)[3].max() < 1e-2
    assert np_(kfin).max() > 1
