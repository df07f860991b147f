"""CLIP ViT-B/16 text encoder (the Talk2DINO text branch input).

Counterpart of legslam_tpu/models/clip_text.py (the reference's
`clip_model.encode_text`, eval/open_vocabulary_segmentation/models/
dinotext/dinotext.py:246-253): token embedding (vocab 49408, width 512, 77
context), 12 transformer layers (8 heads, quick-GELU, causal mask, pre-LN),
final LayerNorm, EOT-token pooling, text projection 512->512. The weight
converters accept OpenAI CLIP state dicts and HF CLIPTextModel naming.

Parameters are a nested dict of float32 tensors in the JAX package's
layout (dense kernels [in, out], blocks as a list), so a clip_text.npz
written by either package loads in both (models/weights_io.py) and
`params_from_numpy` carries a JAX parameter tree across unchanged. The
forward mirrors the JAX graph op for op (matmul, softmax, matmul: no fused
attention, whose summation order differs); the JAX package computes every
product of this model outside any Pallas kernel.

`tokenize` always raises: the CLIP BPE vocabulary is not in the
repository and the port does not import `transformers`. Callers pass
token ids (talk2dino.build_text_embedding's `tokens`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from legslam_torch.models.dinov2 import params_from_numpy


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab: int = 49408
    context: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    proj_dim: int = 512
    eps: float = 1e-5


def init_params(cfg: ClipTextConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random-init parameters (shapes == converted checkpoints), drawn
    from `generator` on its own device and moved to `device`."""
    def randn(*shape, std=0.02):
        return (torch.randn(*shape, generator=generator,
                            device=generator.device) * std).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    def ones(n):
        return torch.ones(n, device=device)

    def dense(din, dout):
        return dict(kernel=randn(din, dout), bias=zeros(dout))

    def block():
        w = cfg.width
        return dict(ln1=dict(scale=ones(w), bias=zeros(w)),
                    qkv=dense(w, 3 * w), proj=dense(w, w),
                    ln2=dict(scale=ones(w), bias=zeros(w)),
                    fc1=dense(w, 4 * w), fc2=dense(4 * w, w))

    return dict(
        token_embedding=randn(cfg.vocab, cfg.width),
        pos_embedding=randn(cfg.context, cfg.width, std=0.01),
        blocks=[block() for _ in range(cfg.layers)],
        ln_final=dict(scale=ones(cfg.width), bias=zeros(cfg.width)),
        text_projection=randn(cfg.width, cfg.proj_dim))


def _ln(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block(x, p, heads: int, eps: float, mask):
    """One pre-LN transformer block (shared with models/clip_vision.py)."""
    b, n, w = x.shape
    hd = w // heads
    y = _ln(x, p["ln1"], eps)
    qkv = y @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    q, k, v = qkv.split(w, dim=-1)

    def split_heads(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = (q @ k.transpose(-2, -1)) / math.sqrt(hd) + mask
    att = torch.softmax(logits, dim=-1)
    y = (att @ v).transpose(1, 2).reshape(b, n, w)
    y = y @ p["proj"]["kernel"] + p["proj"]["bias"]
    x = x + y
    y = _ln(x, p["ln2"], eps)
    y = _quick_gelu(y @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    y = y @ p["fc2"]["kernel"] + p["fc2"]["bias"]
    return x + y


def encode_text(params: dict, tokens: torch.Tensor,
                cfg: Optional[ClipTextConfig] = None) -> torch.Tensor:
    """tokens [B, 77] integer ids -> [B, proj_dim] embeddings (EOT pooled
    + projected, like CLIP.encode_text), on the parameters' device."""
    cfg = cfg or ClipTextConfig()
    emb = params["token_embedding"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    x = emb[tokens] + params["pos_embedding"]
    n = tokens.shape[1]
    mask = torch.triu(torch.full((n, n), float("-inf"), device=emb.device),
                      1)
    for blk in params["blocks"]:
        x = _block(x, blk, cfg.heads, cfg.eps, mask)
    x = _ln(x, params["ln_final"], cfg.eps)
    # the EOT token has the largest id; argmax returns the first maximum,
    # as jnp.argmax does
    eot = tokens.argmax(-1)
    pooled = x[torch.arange(tokens.shape[0], device=emb.device), eot]
    return pooled @ params["text_projection"]


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _openai_blocks(sd: dict, prefix: str, layers: int) -> list:
    """The blocks of an OpenAI CLIP transformer as numpy trees."""
    blocks = []
    for i in range(layers):
        p = f"{prefix}{i}."

        def t(name):
            return _f32(sd[p + name])
        blocks.append(dict(
            ln1=dict(scale=t("ln_1.weight"), bias=t("ln_1.bias")),
            qkv=dict(kernel=t("attn.in_proj_weight").T,
                     bias=t("attn.in_proj_bias")),
            proj=dict(kernel=t("attn.out_proj.weight").T,
                      bias=t("attn.out_proj.bias")),
            ln2=dict(scale=t("ln_2.weight"), bias=t("ln_2.bias")),
            fc1=dict(kernel=t("mlp.c_fc.weight").T, bias=t("mlp.c_fc.bias")),
            fc2=dict(kernel=t("mlp.c_proj.weight").T,
                     bias=t("mlp.c_proj.bias"))))
    return blocks


def _hf_blocks(sd: dict, prefix: str, layers: int) -> list:
    """The blocks of an HF CLIP encoder as numpy trees (q, k, v fused)."""
    def dense(name):
        return dict(kernel=_f32(sd[name + ".weight"]).T,
                    bias=_f32(sd[name + ".bias"]))

    blocks = []
    for i in range(layers):
        p = f"{prefix}{i}."
        q, k, v = (dense(p + f"self_attn.{n}_proj") for n in "qkv")
        blocks.append(dict(
            ln1=dict(scale=_f32(sd[p + "layer_norm1.weight"]),
                     bias=_f32(sd[p + "layer_norm1.bias"])),
            qkv=dict(kernel=np.concatenate(
                [q["kernel"], k["kernel"], v["kernel"]], 1),
                bias=np.concatenate([q["bias"], k["bias"], v["bias"]])),
            proj=dense(p + "self_attn.out_proj"),
            ln2=dict(scale=_f32(sd[p + "layer_norm2.weight"]),
                     bias=_f32(sd[p + "layer_norm2.bias"])),
            fc1=dense(p + "mlp.fc1"), fc2=dense(p + "mlp.fc2")))
    return blocks


def convert_openai(sd: dict, cfg: Optional[ClipTextConfig] = None,
                   device: str | torch.device = "cuda") -> dict:
    """OpenAI CLIP full-model state dict (arrays or tensors) -> the
    text-branch parameters on `device`."""
    cfg = cfg or ClipTextConfig()
    sd = {k: np.asarray(v) for k, v in sd.items()}
    return params_from_numpy(dict(
        token_embedding=_f32(sd["token_embedding.weight"]),
        pos_embedding=_f32(sd["positional_embedding"]),
        blocks=_openai_blocks(sd, "transformer.resblocks.", cfg.layers),
        ln_final=dict(scale=_f32(sd["ln_final.weight"]),
                      bias=_f32(sd["ln_final.bias"])),
        text_projection=_f32(sd["text_projection"])), device)


def convert_hf(sd: dict, proj: Optional[np.ndarray] = None,
               cfg: Optional[ClipTextConfig] = None,
               device: str | torch.device = "cuda") -> dict:
    """HF CLIPTextModel state dict (+ optional text_projection weight) ->
    parameters on `device`."""
    cfg = cfg or ClipTextConfig()
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if proj is None and "text_projection.weight" in sd:
        proj = sd["text_projection.weight"].T
    if proj is None:
        proj = np.eye(cfg.width, cfg.proj_dim, dtype=np.float32)
    tm = "text_model."
    return params_from_numpy(dict(
        token_embedding=_f32(sd[tm + "embeddings.token_embedding.weight"]),
        pos_embedding=_f32(sd[tm + "embeddings.position_embedding.weight"]),
        blocks=_hf_blocks(sd, tm + "encoder.layers.", cfg.layers),
        ln_final=dict(scale=_f32(sd[tm + "final_layer_norm.weight"]),
                      bias=_f32(sd[tm + "final_layer_norm.bias"])),
        text_projection=_f32(proj)), device)


def tokenize(texts: list[str], context: int = 77) -> np.ndarray:
    """CLIP-style tokenization: not available in the port. The JAX module
    reads the BPE vocabulary through `transformers`; the repository holds
    no vocabulary and the port imports no `transformers`, so this always
    raises. Pass [N, 77] token ids instead."""
    raise RuntimeError(
        "CLIP tokenizer unavailable in legslam_torch (no BPE vocabulary in "
        "the repository, and the port does not import transformers): pass "
        "token ids directly (talk2dino.build_text_embedding(tokens=...))")
