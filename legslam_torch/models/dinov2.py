"""DINOv2 ViT-B/14 with registers: the language-feature backbone.

Counterpart of legslam_tpu/models/dinov2.py (the reference's ONNX DINOv2
encoder, src/encoder_models.cpp:33-115): 518x518 input -> 37x37 patch grid
-> 12 transformer blocks (dim 768, 12 heads, MLP x4, LayerScale) -> final
LayerNorm -> `x_norm_patchtokens` [1369, 768].

Parameters are a nested dict of tensors in the JAX package's layout (dense
kernels [in, out], the patch kernel HWIO, blocks as a list), so a
dinov2.npz written by either package loads in both (models/weights_io.py)
and `params_from_numpy` carries a JAX parameter tree across unchanged.

The forward mirrors the JAX graph op for op, in plain tensor code: the JAX
package computes every product of this model outside any Pallas kernel.
Its `dtype` means what the JAX forward does with it: the patch
convolution's operands and output are rounded to `dtype`; the CLS and
register tokens and every block parameter are rounded to `dtype` and meet
float32 activations, which promote every product back to float32; the
final LayerNorm's parameters are not rounded. So in bfloat16 mode the
weights are bf16 values and all arithmetic after the patch embedding is
float32 (on the card: CUDA-core float32, the package turns TF32 off).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from legslam_torch.config import (ENCODER_FEAT_DIM, ENCODER_INPUT_SIZE,
                                  ENCODER_PATCH, IMAGENET_MEAN, IMAGENET_STD)


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    image_size: int = ENCODER_INPUT_SIZE
    patch_size: int = ENCODER_PATCH
    dim: int = ENCODER_FEAT_DIM
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    num_registers: int = 4
    layer_norm_eps: float = 1e-6
    # native grid the positional embedding was trained at (dinov2 = 518/14)
    pos_grid: int = 37


def tree_map(fn: Callable, tree):
    """`fn` over the leaves of a nested dict / list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a parameter tree of numpy arrays (the
    JAX package's pytree as numpy, or models/weights_io.load_params):
    float32 tensors on `device`, in the same layout."""
    return tree_map(lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=device), tree)


def init_params(cfg: DinoV2Config, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random-init parameters (shapes == converted checkpoints), drawn
    from `generator` on its own device and moved to `device`."""
    d = cfg.dim
    hidden = int(d * cfg.mlp_ratio)
    n_pos = cfg.pos_grid * cfg.pos_grid + 1

    def randn(*shape):
        return torch.randn(*shape, generator=generator,
                           device=generator.device) * 0.02

    def dense(din, dout):
        return dict(kernel=randn(din, dout), bias=torch.zeros(dout))

    def norm():
        return dict(scale=torch.ones(d), bias=torch.zeros(d))

    def block():
        return dict(norm1=norm(), qkv=dense(d, 3 * d), proj=dense(d, d),
                    ls1=torch.full((d,), 1e-5), norm2=norm(),
                    fc1=dense(d, hidden), fc2=dense(hidden, d),
                    ls2=torch.full((d,), 1e-5))

    params = dict(
        patch_embed=dict(kernel=randn(cfg.patch_size, cfg.patch_size, 3, d),
                         bias=torch.zeros(d)),
        cls_token=randn(1, 1, d),
        register_tokens=randn(1, cfg.num_registers, d),
        pos_embed=randn(1, n_pos, d),
        blocks=[block() for _ in range(cfg.depth)],
        norm=norm())
    return tree_map(lambda t: t.to(device), params)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to `dtype`, held in float32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def cast_blocks(params: dict, dtype: torch.dtype) -> dict:
    """`params` with every block parameter rounded to `dtype` (held in
    float32): the JAX forward's per-block `astype(dtype)`. Rounding is
    idempotent, so a caller may cast once and reuse the result."""
    if dtype == torch.float32:
        return params
    return {**params, "blocks": tree_map(lambda t: _round(t, dtype),
                                         params["blocks"])}


def _ln(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _attn(x, p, heads):
    b, n, d = x.shape
    hd = d // heads
    qkv = x @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    q, k, v = qkv.split(d, dim=-1)

    def split_heads(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1)
    out = (w @ v).transpose(1, 2).reshape(b, n, d)
    return out @ p["proj"]["kernel"] + p["proj"]["bias"]


def _block(x, p, cfg: DinoV2Config):
    h = _attn(_ln(x, p["norm1"], cfg.layer_norm_eps), p, cfg.heads)
    x = x + p["ls1"] * h
    h = _ln(x, p["norm2"], cfg.layer_norm_eps)
    h = h @ p["fc1"]["kernel"] + p["fc1"]["bias"]
    h = F.gelu(h)                              # exact (erf) GELU
    h = h @ p["fc2"]["kernel"] + p["fc2"]["bias"]
    return x + p["ls2"] * h


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int,
                          native_grid: int, grid_w: int | None = None
                          ) -> torch.Tensor:
    """Resize the patch position embeddings to a (possibly rectangular)
    grid; identity at the native grid. The JAX module's
    jax.image.resize(..., "bicubic") is the Keys a = -0.5 kernel with
    Pillow-style antialiasing: torch's bicubic with antialias=True (plain
    bicubic is a = -0.75 and lands ~0.4 away). Interpolated in float32."""
    if grid_w is None:
        grid_w = grid_h
    if grid_h == native_grid and grid_w == native_grid:
        return pos_embed
    cls_pos = pos_embed[:, :1]
    d = pos_embed.shape[-1]
    patch = pos_embed[:, 1:].reshape(1, native_grid, native_grid, d)
    patch = F.interpolate(patch.permute(0, 3, 1, 2).float(),
                          size=(grid_h, grid_w), mode="bicubic",
                          align_corners=False, antialias=True)
    patch = patch.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, d)
    return torch.cat([cls_pos, patch.to(pos_embed.dtype)], dim=1)


def _patch_embed(images: torch.Tensor, kernel: torch.Tensor, patch: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The stride-`patch` VALID convolution of [B, H, W, 3] images by an
    HWIO kernel -> [B, (H/p)*(W/p), dim] in `dtype`: operands rounded to
    `dtype`, products summed in float32, the sum rounded once to `dtype`
    (XLA's bf16 convolution on the CPU; the same on every device)."""
    x = _round(images, dtype).permute(0, 3, 1, 2)
    w = _round(kernel, dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x, w, stride=patch).to(dtype)
    return y.flatten(2).transpose(1, 2)


def forward_cast(params: dict, images: torch.Tensor, cfg: DinoV2Config,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`forward` on parameters already passed through cast_blocks."""
    b, h, w, _ = images.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    x = _patch_embed(images, params["patch_embed"]["kernel"],
                     cfg.patch_size, dtype)
    x = x + params["patch_embed"]["bias"]              # promotes to float32

    pos = interpolate_pos_embed(params["pos_embed"], gh, cfg.pos_grid, gw)
    cls_tok = params["cls_token"] + pos[:, :1]
    x = x + pos[:, 1:]
    regs = params["register_tokens"].expand(b, cfg.num_registers, cfg.dim)
    x = torch.cat([_round(cls_tok.expand(b, 1, cfg.dim), dtype),
                   _round(regs, dtype), x], dim=1)

    for blk in params["blocks"]:
        x = _block(x, blk, cfg)

    x = _ln(x.float(), params["norm"], cfg.layer_norm_eps)
    return x[:, 1 + cfg.num_registers:]


def forward(params: dict, images: torch.Tensor, cfg: DinoV2Config,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """images [B, H, W, 3] (already ImageNet-normalized) ->
    x_norm_patchtokens [B, (H/14)*(W/14), dim] (float32)."""
    return forward_cast(cast_blocks(params, dtype), images, cfg, dtype)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

def _get(sd: dict, name: str) -> np.ndarray:
    x = sd[name]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def convert_torch_hub(sd: dict, cfg: Optional[DinoV2Config] = None,
                      device: str | torch.device = "cuda") -> dict:
    """torch-hub dinov2_vitb14_reg state dict (torch or numpy values) ->
    the port's parameters on `device`."""
    cfg = cfg or DinoV2Config()

    def t(name):
        return _get(sd, name)

    def dense(prefix):
        return dict(kernel=t(prefix + ".weight").T, bias=t(prefix + ".bias"))

    blocks = []
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        blocks.append(dict(
            norm1=dict(scale=t(p + "norm1.weight"), bias=t(p + "norm1.bias")),
            qkv=dense(p + "attn.qkv"),
            proj=dense(p + "attn.proj"),
            ls1=t(p + "ls1.gamma"),
            norm2=dict(scale=t(p + "norm2.weight"), bias=t(p + "norm2.bias")),
            fc1=dense(p + "mlp.fc1"),
            fc2=dense(p + "mlp.fc2"),
            ls2=t(p + "ls2.gamma"),
        ))
    return params_from_numpy(dict(
        patch_embed=dict(
            # torch conv [out, in, kh, kw] -> HWIO
            kernel=t("patch_embed.proj.weight").transpose(2, 3, 1, 0),
            bias=t("patch_embed.proj.bias")),
        cls_token=t("cls_token"),
        register_tokens=t("register_tokens"),
        pos_embed=t("pos_embed"),
        blocks=blocks,
        norm=dict(scale=t("norm.weight"), bias=t("norm.bias")),
    ), device)


def convert_hf(sd: dict, cfg: Optional[DinoV2Config] = None,
               device: str | torch.device = "cuda") -> dict:
    """HF Dinov2WithRegistersModel state dict (torch or numpy values) ->
    the port's parameters on `device`."""
    cfg = cfg or DinoV2Config()

    def t(name):
        return _get(sd, name)

    def dense(prefix):
        return dict(kernel=t(prefix + ".weight").T, bias=t(prefix + ".bias"))

    blocks = []
    for i in range(cfg.depth):
        p = f"encoder.layer.{i}."
        q = dense(p + "attention.attention.query")
        k = dense(p + "attention.attention.key")
        v = dense(p + "attention.attention.value")
        qkv = dict(
            kernel=np.concatenate([q["kernel"], k["kernel"], v["kernel"]],
                                  axis=1),
            bias=np.concatenate([q["bias"], k["bias"], v["bias"]]))
        blocks.append(dict(
            norm1=dict(scale=t(p + "norm1.weight"), bias=t(p + "norm1.bias")),
            qkv=qkv,
            proj=dense(p + "attention.output.dense"),
            ls1=t(p + "layer_scale1.lambda1"),
            norm2=dict(scale=t(p + "norm2.weight"), bias=t(p + "norm2.bias")),
            fc1=dense(p + "mlp.fc1"),
            fc2=dense(p + "mlp.fc2"),
            ls2=t(p + "layer_scale2.lambda1"),
        ))
    return params_from_numpy(dict(
        patch_embed=dict(
            kernel=t("embeddings.patch_embeddings.projection.weight")
            .transpose(2, 3, 1, 0),
            bias=t("embeddings.patch_embeddings.projection.bias")),
        cls_token=t("embeddings.cls_token"),
        register_tokens=t("embeddings.register_tokens"),
        pos_embed=t("embeddings.position_embeddings"),
        blocks=blocks,
        norm=dict(scale=t("layernorm.weight"), bias=t("layernorm.bias")),
    ), device)


def imagenet_normalize(rgb: torch.Tensor, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> ImageNet-normalized
    (include/encoder_models.h:81-82). `mean` and `std` may be tensors
    already on rgb's device: building them from the host constants is a
    blocking host-to-device copy, which a per-frame caller avoids."""
    mean = torch.as_tensor(mean, dtype=rgb.dtype, device=rgb.device)
    std = torch.as_tensor(std, dtype=rgb.dtype, device=rgb.device)
    return (rgb - mean) / std
