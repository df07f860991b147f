"""legslam_torch.models.talk2dino against the JAX package: the text query
embedding from token ids, the image-as-query embedding, cosine heatmaps,
the reference projection checkpoint read by both packages, and the text /
image pipelines loaded from a weights directory the JAX package wrote.
Small config: CLIP width 64, 2 layers, projection 32 -> 48, PCA 48 -> 8."""
import os

import jax
import numpy as np
import pytest
import torch

from legslam_torch.models import pca as TPCA
from legslam_torch.models import talk2dino as TT
from legslam_torch.models import weights_io as TW
from legslam_torch.models.clip_text import ClipTextConfig as TTextCfg
from legslam_torch.models.clip_text import params_from_numpy as text_params
from legslam_torch.models.clip_vision import ClipVisionConfig as TVisCfg
from legslam_torch.models.clip_vision import params_from_numpy as vis_params
from legslam_tpu.models import clip_text as JCT
from legslam_tpu.models import clip_vision as JCV
from legslam_tpu.models import pca as JPCA
from legslam_tpu.models import talk2dino as JT
from legslam_tpu.models import weights_io as JW
from tests.test_torch_clip import TEXT, VISION, token_ids
from tests.torch_parity import np_

torch.set_num_threads(1)

CATEGORIES = ("chair", "table", "sofa")


def jax_query_weights(seed=0):
    """Small-config JAX trees (numpy): CLIP text and vision parameters,
    the Talk2DINO projection (32 -> 48, one hidden layer) and a PCA
    48 -> 8 with a nonzero mean."""
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    tree = jax.tree.map(np.asarray, dict(
        text=JCT.init_params(JCT.ClipTextConfig(**TEXT), k1),
        vision=JCV.init_params(JCV.ClipVisionConfig(**VISION), k2)))
    proj = JT.ProjectionParams(*jax.tree.map(
        np.asarray, tuple(JT.init_projection(k3, clip_dim=32, dino_dim=48))))
    rng = np.random.default_rng(seed)
    pca = JPCA.PCAParams(
        mean=(rng.normal(size=48) * 0.01).astype(np.float32),
        components=rng.normal(size=(8, 48)).astype(np.float32))
    return tree["text"], tree["vision"], proj, pca


def write_jax_weights_dir(path, seed=0):
    """A weights directory as the JAX package writes it
    (tools/convert_weights.py's files); returns the JAX trees."""
    text, vision, proj, pca = jax_query_weights(seed)
    os.makedirs(path, exist_ok=True)
    JW.save_params(os.path.join(path, "clip_text.npz"), text)
    JW.save_params(os.path.join(path, "clip_vision.npz"), vision)
    JW.save_params(os.path.join(path, "talk2dino_proj.npz"), dict(
        linear_w=proj.linear_w, linear_b=proj.linear_b,
        hidden_ws=list(proj.hidden_ws), hidden_bs=list(proj.hidden_bs)))
    JPCA.save(os.path.join(path, "pca.npz"), pca)
    return text, vision, proj, pca


def _torch_pca(pca):
    return TPCA.PCAParams(torch.as_tensor(pca.mean),
                          torch.as_tensor(pca.components))


def test_text_embedding_matches_jax():
    """build_text_embedding with token ids [3, 7, 16]: with and without
    the PCA, within atol 1e-5 of JAX (measured 7.2e-7 on values up to
    1.8)."""
    text, _, proj, pca = jax_query_weights()
    toks = token_ids(np.random.default_rng(1), 3 * 7, 16, 99) \
        .reshape(3, 7, 16)
    for p_j, p_t in ((pca, _torch_pca(pca)), (None, None)):
        want = np.asarray(JT.build_text_embedding(
            CATEGORIES, text, proj, p_j, tokens=toks,
            clip_cfg=JCT.ClipTextConfig(**TEXT)))
        got = TT.build_text_embedding(
            CATEGORIES, text_params(text, "cpu"),
            TT.params_from_numpy(proj, "cpu"), p_t, tokens=toks,
            clip_cfg=TTextCfg(**TEXT))
        assert got.shape == want.shape == (3, 8 if p_j else 48)
        np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)


def test_image_embedding_matches_jax():
    """build_image_embedding on a 40x60 frame (resize to 32, CLIP vision,
    projection, L2 norm, PCA) within atol 1e-5 of JAX (measured 5.4e-7
    on values up to 1.7)."""
    _, vision, proj, pca = jax_query_weights()
    rgb = np.random.default_rng(2).uniform(size=(40, 60, 3)) \
        .astype(np.float32)
    for p_j, p_t in ((pca, _torch_pca(pca)), (None, None)):
        want = np.asarray(JT.build_image_embedding(
            vision, proj, p_j, rgb, vision_cfg=JCV.ClipVisionConfig(**VISION)))
        got = TT.build_image_embedding(
            vis_params(vision, "cpu"), TT.params_from_numpy(proj, "cpu"),
            p_t, rgb, vision_cfg=TVisCfg(**VISION))
        assert got.shape == want.shape
        np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)
    assert abs(float(torch.linalg.norm(got)) - 1.0) < 1e-5


@pytest.mark.parametrize("invert", [True, False])
def test_cosine_heatmap_matches_jax(invert):
    """[2, 12, 20] heatmaps of a 64-D LF image against 2 embeddings:
    within 1e-6 of JAX; inverted, each map spans [0, 1]."""
    rng = np.random.default_rng(3)
    lf = rng.normal(size=(12, 20, 64)).astype(np.float32)
    te = rng.normal(size=(2, 64)).astype(np.float32)
    want = np.asarray(JT.cosine_heatmap(lf, te, invert=invert))
    got = np_(TT.cosine_heatmap(torch.as_tensor(lf), torch.as_tensor(te),
                                invert=invert))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if invert:
        np.testing.assert_allclose(got.min((1, 2)), 0.0, atol=1e-6)
        np.testing.assert_allclose(got.max((1, 2)), 1.0, atol=1e-6)


def test_load_projection_reads_reference_checkpoint(tmp_path):
    """A vitb_mlp_infonce.pth-layout checkpoint read by both packages'
    load_projection: the same kernels (transposed) bit for bit."""
    g = torch.Generator().manual_seed(4)
    sd = {"linear_layer.weight": torch.randn(48, 32, generator=g),
          "linear_layer.bias": torch.randn(48, generator=g)}
    for i in range(2):
        sd[f"hidden_layers.{i}.weight"] = torch.randn(48, 48, generator=g)
        sd[f"hidden_layers.{i}.bias"] = torch.randn(48, generator=g)
    path = str(tmp_path / "proj.pth")
    torch.save(sd, path)
    j = JT.load_projection(path)
    t = TT.load_projection(path, device="cpu")
    assert len(t.hidden_ws) == len(j.hidden_ws) == 2
    for a, b in zip(jax.tree.leaves(tuple(t)), jax.tree.leaves(tuple(j))):
        assert np.array_equal(np_(a), np.asarray(b))
    np.testing.assert_array_equal(np_(t.linear_w),
                                  sd["linear_layer.weight"].numpy().T)


def test_pipelines_from_a_jax_weights_dir(tmp_path):
    """load_text_pipeline / load_image_pipeline on a directory the JAX
    package wrote: the same text and image query embeddings as JAX's
    pipelines on the same files (atol 1e-5)."""
    wdir = str(tmp_path / "weights")
    write_jax_weights_dir(wdir, seed=5)
    toks = token_ids(np.random.default_rng(6), 2 * 7, 16, 99) \
        .reshape(2, 7, 16)
    jc, jp, jpca = JW.load_text_pipeline(wdir)
    tc, tp, tpca = TW.load_text_pipeline(wdir, device="cpu")
    want = np.asarray(JT.build_text_embedding(
        CATEGORIES[:2], jc, jp, jpca, tokens=toks,
        clip_cfg=JCT.ClipTextConfig(**TEXT)))
    got = TT.build_text_embedding(CATEGORIES[:2], tc, tp, tpca, tokens=toks,
                                  clip_cfg=TTextCfg(**TEXT))
    np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)

    rgb = np.random.default_rng(7).uniform(size=(30, 50, 3)) \
        .astype(np.float32)
    jv, jp, jpca = JW.load_image_pipeline(wdir)
    tv, tp, tpca = TW.load_image_pipeline(wdir, device="cpu")
    want = np.asarray(JT.build_image_embedding(
        jv, jp, jpca, rgb, vision_cfg=JCV.ClipVisionConfig(**VISION)))
    got = TT.build_image_embedding(tv, tp, tpca, rgb,
                                   vision_cfg=TVisCfg(**VISION))
    np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)
