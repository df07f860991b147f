"""legslam_torch.models.{clip_text,clip_vision} against the JAX package:
the forwards on shared random weights at a small config (2 layers, width
64), the in-repo golden fixtures at JAX's own tolerance, the CLIP
preprocess, the OpenAI / HF converters, EOT pooling and the tokenizer's
refusal."""
import os

import jax
import numpy as np
import pytest
import torch

from legslam_torch.models import clip_text as TCT
from legslam_torch.models import clip_vision as TCV
from legslam_tpu.models import clip_text as JCT
from legslam_tpu.models import clip_vision as JCV
from tests.torch_parity import np_
from tools.make_golden_fixtures import unflatten

torch.set_num_threads(1)

TEXT = dict(vocab=99, context=16, width=64, layers=2, heads=2, proj_dim=32)
VISION = dict(image_size=32, patch=16, width=64, layers=2, heads=2,
              proj_dim=32)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def token_ids(rng, n, context, vocab, lengths=None):
    """[n, context] ids: SOT-like first id, random body, the EOT (the
    largest id, vocab - 1) after it, zero padding."""
    toks = np.zeros((n, context), np.int32)
    for i in range(n):
        ln = int(lengths[i]) if lengths is not None else \
            int(rng.integers(1, context - 1))
        toks[i, 0] = vocab - 2
        toks[i, 1:ln + 1] = rng.integers(1, vocab - 2, size=ln)
        toks[i, ln + 1] = vocab - 1
    return toks


def test_encode_text_matches_jax():
    """Shared random weights: the port within atol 1e-5 of JAX (measured
    2.1e-7 on embeddings up to 0.62)."""
    cfg_j, cfg_t = JCT.ClipTextConfig(**TEXT), TCT.ClipTextConfig(**TEXT)
    params = _tree_np(JCT.init_params(cfg_j, jax.random.key(0)))
    toks = token_ids(np.random.default_rng(0), 5, 16, 99)
    want = np.asarray(JCT.encode_text(params, toks, cfg_j))
    got = TCT.encode_text(TCT.params_from_numpy(params, "cpu"),
                          torch.as_tensor(toks), cfg_t)
    assert got.shape == (5, 32)
    np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)


def test_encode_image_matches_jax():
    """Shared random weights on CLIP-normalised images: atol 1e-5
    (measured 6e-8 on embeddings up to 0.27)."""
    cfg_j, cfg_t = JCV.ClipVisionConfig(**VISION), \
        TCV.ClipVisionConfig(**VISION)
    params = _tree_np(JCV.init_params(cfg_j, jax.random.key(1)))
    img = np.random.default_rng(1).normal(size=(3, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(JCV.encode_image(params, img, cfg_j))
    got = TCV.encode_image(TCV.params_from_numpy(params, "cpu"), img, cfg_t)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(np_(got), want, atol=1e-5, rtol=0)


def _golden(name):
    with np.load(os.path.join(FIXTURES, f"{name}.npz")) as blob:
        params = unflatten({k[len("param:"):]: blob[k] for k in blob.files
                            if k.startswith("param:")})
        rest = {k: blob[k] for k in blob.files if not k.startswith("param:")}
    return params, rest


@pytest.mark.parametrize("which", ["text", "vision"])
def test_golden_fixtures(which):
    """The HF-torch goldens at JAX's tolerance (atol 2e-4 / rtol 1e-3,
    tests/test_golden_fixtures.py)."""
    if which == "text":
        params, rest = _golden("golden_clip_text")
        got = TCT.encode_text(TCT.params_from_numpy(params, "cpu"),
                              rest["input:tokens"],
                              TCT.ClipTextConfig(**TEXT))
        want = rest["golden:text_embeds"]
    else:
        params, rest = _golden("golden_clip_vision")
        got = TCV.encode_image(TCV.params_from_numpy(params, "cpu"),
                               rest["input:images"],
                               TCV.ClipVisionConfig(**VISION))
        want = rest["golden:image_embeds"]
    assert got.shape == want.shape
    np.testing.assert_allclose(np_(got), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("hw", [(68, 120), (300, 400)])
def test_preprocess_matches_jax(hw):
    """Resize to 224 + CLIP normalisation: up (120x68) and down (400x300,
    where jax.image.resize antialiases) within atol 1e-4 of JAX on values
    up to ~2.2 (measured: the shrink 3.9e-5, the enlargement 1.3e-5, at
    0.3% and 0.03% of the values above 1e-5: the two resizes compute
    their weights in another order)."""
    rgb = np.random.default_rng(2).uniform(size=hw + (3,)) \
        .astype(np.float32)
    want = np.asarray(JCV.preprocess(rgb))
    got = TCV.preprocess(rgb)
    assert got.shape == want.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(np_(got), want, atol=1e-4, rtol=0)


def _openai_sd(rng, prefix, width, layers, extra):
    sd = {}
    for i in range(layers):
        p = f"{prefix}{i}."
        for name, shape in (
                ("ln_1.weight", (width,)), ("ln_1.bias", (width,)),
                ("attn.in_proj_weight", (3 * width, width)),
                ("attn.in_proj_bias", (3 * width,)),
                ("attn.out_proj.weight", (width, width)),
                ("attn.out_proj.bias", (width,)),
                ("ln_2.weight", (width,)), ("ln_2.bias", (width,)),
                ("mlp.c_fc.weight", (4 * width, width)),
                ("mlp.c_fc.bias", (4 * width,)),
                ("mlp.c_proj.weight", (width, 4 * width)),
                ("mlp.c_proj.bias", (width,))):
            sd[p + name] = rng.normal(size=shape).astype(np.float32)
    for name, shape in extra.items():
        sd[name] = rng.normal(size=shape).astype(np.float32)
    return sd


def _hf_sd(rng, prefix, width, layers, extra):
    sd = {}
    for i in range(layers):
        p = f"{prefix}{i}."
        for n in ("q", "k", "v", "out"):
            sd[p + f"self_attn.{n}_proj.weight"] = rng.normal(
                size=(width, width)).astype(np.float32)
            sd[p + f"self_attn.{n}_proj.bias"] = rng.normal(
                size=(width,)).astype(np.float32)
        for n in ("layer_norm1", "layer_norm2"):
            sd[p + n + ".weight"] = rng.normal(size=(width,)) \
                .astype(np.float32)
            sd[p + n + ".bias"] = rng.normal(size=(width,)).astype(np.float32)
        sd[p + "mlp.fc1.weight"] = rng.normal(size=(4 * width, width)) \
            .astype(np.float32)
        sd[p + "mlp.fc1.bias"] = rng.normal(size=(4 * width,)) \
            .astype(np.float32)
        sd[p + "mlp.fc2.weight"] = rng.normal(size=(width, 4 * width)) \
            .astype(np.float32)
        sd[p + "mlp.fc2.bias"] = rng.normal(size=(width,)).astype(np.float32)
    for name, shape in extra.items():
        sd[name] = rng.normal(size=shape).astype(np.float32)
    return sd


def _state_dict(kind, rng):
    w, n = 64, 2
    if kind == "text_openai":
        return _openai_sd(rng, "transformer.resblocks.", w, n, {
            "token_embedding.weight": (99, w), "positional_embedding": (16, w),
            "ln_final.weight": (w,), "ln_final.bias": (w,),
            "text_projection": (w, 32)})
    if kind == "text_hf":
        tm = "text_model."
        return _hf_sd(rng, tm + "encoder.layers.", w, n, {
            tm + "embeddings.token_embedding.weight": (99, w),
            tm + "embeddings.position_embedding.weight": (16, w),
            tm + "final_layer_norm.weight": (w,),
            tm + "final_layer_norm.bias": (w,),
            "text_projection.weight": (32, w)})
    if kind == "vision_openai":
        return _openai_sd(rng, "visual.transformer.resblocks.", w, n, {
            "visual.conv1.weight": (w, 3, 16, 16),
            "visual.class_embedding": (w,),
            "visual.positional_embedding": (5, w),
            "visual.ln_pre.weight": (w,), "visual.ln_pre.bias": (w,),
            "visual.ln_post.weight": (w,), "visual.ln_post.bias": (w,),
            "visual.proj": (w, 32)})
    vm = "vision_model."
    return _hf_sd(rng, vm + "encoder.layers.", w, n, {
        vm + "embeddings.patch_embedding.weight": (w, 3, 16, 16),
        vm + "embeddings.class_embedding": (w,),
        vm + "embeddings.position_embedding.weight": (5, w),
        vm + "pre_layrnorm.weight": (w,), vm + "pre_layrnorm.bias": (w,),
        vm + "post_layernorm.weight": (w,), vm + "post_layernorm.bias": (w,),
        "visual_projection.weight": (32, w)})


@pytest.mark.parametrize("kind", ["text_openai", "text_hf", "vision_openai",
                                  "vision_hf"])
def test_converters_match_jax(kind):
    """A synthetic state dict through both packages' converters: the same
    tree bit for bit, and the same forward within atol 1e-5."""
    sd = _state_dict(kind, np.random.default_rng(3))
    fmt = kind.split("_")[1]
    if kind.startswith("text"):
        jmod, tmod, jcfg, tcfg = JCT, TCT, JCT.ClipTextConfig(**TEXT), \
            TCT.ClipTextConfig(**TEXT)
    else:
        jmod, tmod, jcfg, tcfg = JCV, TCV, JCV.ClipVisionConfig(**VISION), \
            TCV.ClipVisionConfig(**VISION)
    conv_j = getattr(jmod, f"convert_{fmt}")
    conv_t = getattr(tmod, f"convert_{fmt}")
    want = _tree_np(conv_j(sd, cfg=jcfg))
    got = conv_t({k: torch.as_tensor(v) for k, v in sd.items()}, cfg=tcfg,
                 device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(want)
    flat_t = jax.tree_util.tree_leaves_with_path(jax.tree.map(np_, got))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert np.array_equal(a, b)
    if kind.startswith("text"):
        x = token_ids(np.random.default_rng(4), 3, 16, 99)
        a = np.asarray(JCT.encode_text(want, x, jcfg))
        b = TCT.encode_text(got, x, tcfg)
    else:
        x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)) \
            .astype(np.float32)
        a = np.asarray(JCV.encode_image(want, x, jcfg))
        b = TCV.encode_image(got, x, tcfg)
    scale = max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(np_(b), a, atol=1e-5 * scale, rtol=0)


def test_eot_pooling_on_padded_ids():
    """The EOT (largest id) token is pooled, the first one where the
    largest id repeats (jnp.argmax's rule, held against JAX), and the
    padding after it changes nothing (the causal mask)."""
    cfg_j, cfg_t = JCT.ClipTextConfig(**TEXT), TCT.ClipTextConfig(**TEXT)
    params = _tree_np(JCT.init_params(cfg_j, jax.random.key(5)))
    tparams = TCT.params_from_numpy(params, "cpu")
    rng = np.random.default_rng(5)
    toks = token_ids(rng, 3, 16, 99, lengths=[3, 3, 6])
    toks[1, :5] = toks[0, :5]                      # row 0 up to its EOT
    toks[1, 7:] = rng.integers(1, 97, size=9)     # other padding
    toks[2, 10] = 98                               # a second EOT id
    got = np_(TCT.encode_text(tparams, toks, cfg_t))
    want = np.asarray(JCT.encode_text(params, toks, cfg_j))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0], got[1], atol=1e-6, rtol=0)
    first = toks[2].copy()
    first[10] = 0
    np.testing.assert_allclose(
        np_(TCT.encode_text(tparams, first[None], cfg_t))[0], got[2],
        atol=1e-6, rtol=0)


def test_tokenize_raises_without_vocabulary():
    with pytest.raises(RuntimeError, match="token ids"):
        TCT.tokenize(["a chair"])
