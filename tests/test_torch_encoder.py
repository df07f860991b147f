"""legslam_torch's language-feature encoder stack against the JAX
package's, on the CPU: LanguageFeaturesEncoder (resize, /255, ImageNet
normalisation, DINOv2, per-token L2 norm, PCA, reshape), the PCA's fit,
apply and ONNX reader, and the .npz weight files both packages write.

The encoder runs at the small DINOv2 config (56x56 input, 4x4 grid, width
64) with a 64-component PCA. Tolerance of the LF grids: atol 2e-4 / rtol
1e-3, the DINOv2 forward's float32 tolerance, in both float32 and the
default bfloat16 mode (bf16 weights, float32 arithmetic in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_torch.models import dinov2 as TD
from legslam_torch.models import pca as TPCA
from legslam_torch.models import weights_io as TW
from legslam_torch.models.encoder import LanguageFeaturesEncoder
from legslam_tpu.models import dinov2 as JD
from legslam_tpu.models import pca as JPCA
from legslam_tpu.models import weights_io as JW
from legslam_tpu.models.encoder import \
    LanguageFeaturesEncoder as JaxEncoder
from tests.test_encoder_stack import _encode_onnx_pca

torch.set_num_threads(1)

SMALL = dict(image_size=56, patch_size=14, dim=64, depth=2, heads=2,
             num_registers=4, pos_grid=4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def weights():
    """Seeded small DINOv2 parameters (every LayerScale, bias and norm
    perturbed) and an orthonormal 64 -> 64 PCA with a nonzero mean, as
    numpy trees."""
    rng = np.random.default_rng(11)
    jp = JD.init_params(JD.DinoV2Config(**SMALL), jax.random.key(1))
    dino = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1)
        .astype(np.float32), jp)
    q, _ = np.linalg.qr(rng.normal(size=(64, 64)))
    pca = dict(mean=(rng.normal(size=64) * 0.01).astype(np.float32),
               components=q.astype(np.float32))
    return dino, pca


def _encoders(weights, dtype):
    dino, pca = weights
    jd, td = DTYPES[dtype]
    jenc = JaxEncoder(jax.tree.map(jnp.asarray, dino),
                      JPCA.PCAParams(jnp.asarray(pca["mean"]),
                                     jnp.asarray(pca["components"])),
                      JD.DinoV2Config(**SMALL), dtype=jd)
    tenc = LanguageFeaturesEncoder(
        TD.params_from_numpy(dino, "cpu"),
        TPCA.PCAParams(torch.as_tensor(pca["mean"]),
                       torch.as_tensor(pca["components"])),
        TD.DinoV2Config(**SMALL), dtype=td, device="cpu")
    return jenc, tenc


CASES = {
    "float_shrink": (90, 120, "float"),   # antialiased resize down
    "uint8_grow": (30, 40, "uint8"),      # /255 on the device, resize up
    "at_size": (56, 56, "float"),         # the resize is skipped
    "batch_of_2": (2, 90, 120, "float"),  # encode_batch
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_encoder_matches_jax(weights, dtype, case):
    *shape, kind = CASES[case]
    rng = np.random.default_rng(12)
    if kind == "uint8":
        rgb = rng.integers(0, 256, size=(*shape, 3)).astype(np.uint8)
    else:
        rgb = rng.uniform(size=(*shape, 3)).astype(np.float32)
    jenc, tenc = _encoders(weights, dtype)
    if len(shape) == 3:
        want = np.asarray(jenc.encode_batch(jnp.asarray(rgb)))
        got = tenc.encode_batch(rgb)
        assert got.shape == (2, 4, 4, 64)
    else:
        want = np.asarray(jenc.create_language_features(jnp.asarray(rgb)))
        got = tenc.create_language_features(rgb)
        assert got.shape == (4, 4, 64)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    # a tensor input gives the same grid as the numpy one
    again = tenc.encode_batch(torch.as_tensor(rgb)[None]) if \
        len(shape) == 2 else tenc.encode_batch(torch.as_tensor(rgb))
    assert torch.equal(again.reshape(got.shape), got)


def test_pca_fit_and_apply_match_jax():
    rng = np.random.default_rng(13)
    basis = rng.normal(size=(8, 32)).astype(np.float32)
    z = rng.normal(size=(5000, 8)).astype(np.float32) * \
        np.array([10, 8, 6, 4, 2, 1, 0.5, 0.1], np.float32)
    feats = z @ basis + rng.normal(scale=0.01, size=(5000, 32)) \
        .astype(np.float32) + 3.0
    batches = [feats[:2500], feats[2500:]]
    ref = JPCA.fit_pca(batches, k=8)
    got = TPCA.fit_pca(batches, k=8, device="cpu")
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-5, atol=1e-5)
    # components agree up to sign
    cj, ct = np.asarray(ref.components), got.components.numpy()
    sign = np.sign(np.sum(cj * ct, axis=1, keepdims=True))
    np.testing.assert_allclose(ct * sign, cj, atol=2e-3)
    np.testing.assert_allclose(ct @ ct.T, np.eye(8), atol=1e-4)
    x = feats[:7]
    want = np.asarray(JPCA.apply_pca(ref, jnp.asarray(x)))
    out = TPCA.apply_pca(got, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out * sign[:, 0], want, atol=2e-2, rtol=1e-3)
    # the same parameters give the same projection
    same = TPCA.apply_pca(TPCA.PCAParams(torch.tensor(np.asarray(
        ref.mean)), torch.tensor(cj)), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(same, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
def test_pca_from_onnx_matches_jax(tmp_path, transposed):
    rng = np.random.default_rng(14)
    mean = rng.normal(size=(768,)).astype(np.float32)
    comp = rng.normal(size=(64, 768)).astype(np.float32)
    path = str(tmp_path / "pca_text_emb64_test.onnx")
    if transposed:   # a [1, D] mean and the [D, K] export of x @ W
        _encode_onnx_pca(path, mean.reshape(1, -1),
                         np.ascontiguousarray(comp.T))
    else:
        _encode_onnx_pca(path, mean, comp)
    ref = JPCA.from_onnx(path)
    got = TPCA.from_onnx(path, device="cpu")
    assert np.array_equal(got.mean.numpy(), np.asarray(ref.mean))
    assert np.array_equal(got.components.numpy(), np.asarray(ref.components))
    assert np.array_equal(got.components.numpy(), comp)


def test_weight_files_load_in_both(weights, tmp_path):
    """dinov2.npz + pca.npz written by JAX's save_params / pca.save load
    through the port's load_encoder and give JAX's LF; the port's files
    load in JAX bit for bit."""
    dino, pca = weights
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    JW.save_params(str(jdir / "dinov2.npz"), jax.tree.map(jnp.asarray, dino))
    JPCA.save(str(jdir / "pca.npz"), JPCA.PCAParams(
        jnp.asarray(pca["mean"]), jnp.asarray(pca["components"])))
    tenc = TW.load_encoder(str(jdir), device="cpu",
                           cfg=TD.DinoV2Config(**SMALL))
    assert tenc.dtype == torch.bfloat16
    jenc, _ = _encoders(weights, "bfloat16")
    rgb = np.random.default_rng(15).uniform(size=(90, 120, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tenc.create_language_features(rgb).numpy(),
        np.asarray(jenc.create_language_features(jnp.asarray(rgb))),
        atol=2e-4, rtol=1e-3)

    TW.save_params(str(tdir / "dinov2.npz"), tenc.dino_params)
    TPCA.save(str(tdir / "pca.npz"), tenc.pca_params)
    back = JW.load_params(str(tdir / "dinov2.npz"))
    flat_j = jax.tree_util.tree_leaves_with_path(back)
    flat_d = jax.tree_util.tree_leaves_with_path(dino)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_d]
    for (_, a), (_, b) in zip(flat_j, flat_d):
        assert np.array_equal(np.asarray(a), b)
    pj = JPCA.load(str(tdir / "pca.npz"))
    assert np.array_equal(np.asarray(pj.components), pca["components"])
    # and the port reads its own files back to the same tree
    mine = TW.load_params(str(tdir / "dinov2.npz"))
    assert np.array_equal(mine["blocks"][1]["qkv"]["kernel"],
                          dino["blocks"][1]["qkv"]["kernel"])


def test_query_pipelines_raise(tmp_path):
    """The query pipelines load a JAX-written weights directory (they
    raised before the CLIP stack was ported): every tensor equals JAX's
    bit for bit. What still raises is the tokenizer: a text embedding
    without token ids (no BPE vocabulary in the repository)."""
    from legslam_torch.models import talk2dino as TT
    from tests.test_torch_talk2dino import write_jax_weights_dir
    wdir = str(tmp_path / "weights")
    write_jax_weights_dir(wdir)
    for tfn, jfn in ((TW.load_text_pipeline, JW.load_text_pipeline),
                     (TW.load_image_pipeline, JW.load_image_pipeline)):
        got = tfn(wdir, device="cpu")
        want = jfn(wdir)
        flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
        flat_j = jax.tree.leaves(want)
        assert len(flat_t) == len(flat_j) > 0
        for a, b in zip(flat_t, flat_j):
            assert np.array_equal(a, np.asarray(b))
    clip, proj, pca = TW.load_text_pipeline(wdir, device="cpu")
    with pytest.raises(RuntimeError, match="token ids"):
        TT.build_text_embedding(["chair"], clip, proj, pca)
