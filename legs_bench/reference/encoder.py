"""Plain reference of the language-feature encoder: DINOv2 ViT-B/14 with
registers, per-token L2 normalisation and the PCA 768 -> 64, in plain
torch. Frozen copies of legslam_torch/models/dinov2.py:112-205 (the
forward), models/pca.py:25-27 (apply) and models/encoder.py:63-86
(`encode`), taking the weights the benchmark made. `dtype` bfloat16 is
the configuration's "bf16 weights, float32 arithmetic": the patch
convolution's operands and output are rounded to it, every block
parameter is rounded to it, and all arithmetic after the patch embedding
is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


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
    w = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd), dim=-1)
    out = (w @ v).transpose(1, 2).reshape(b, n, d)
    return out @ p["proj"]["kernel"] + p["proj"]["bias"]


def _block(x, p, heads, eps):
    x = x + p["ls1"] * _attn(_ln(x, p["norm1"], eps), p, heads)
    h = _ln(x, p["norm2"], eps)
    h = F.gelu(h @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    return x + p["ls2"] * (h @ p["fc2"]["kernel"] + p["fc2"]["bias"])


def dino_forward(params: dict, images: torch.Tensor, cfg: dict,
                 dtype: torch.dtype) -> torch.Tensor:
    """[B, 518, 518, 3] normalised images -> patch tokens [B, 1369, 768]
    (the native 37 x 37 grid, so the position embedding is used as it
    is)."""
    b = images.shape[0]
    dim, nreg, patch = cfg["dim"], cfg["num_registers"], cfg["patch_size"]
    blocks = [{k: (_round(v, dtype) if torch.is_tensor(v) else
                   {kk: _round(vv, dtype) for kk, vv in v.items()})
               for k, v in blk.items()} for blk in params["blocks"]]
    x = _round(images, dtype).permute(0, 3, 1, 2)
    w = _round(params["patch_embed"]["kernel"], dtype).permute(3, 2, 0, 1)
    x = F.conv2d(x, w, stride=patch).to(dtype).flatten(2).transpose(1, 2)
    x = x + params["patch_embed"]["bias"]
    pos = params["pos_embed"]
    cls_tok = params["cls_token"] + pos[:, :1]
    x = x + pos[:, 1:]
    regs = params["register_tokens"].expand(b, nreg, dim)
    x = torch.cat([_round(cls_tok.expand(b, 1, dim), dtype),
                   _round(regs, dtype), x], dim=1)
    for blk in blocks:
        x = _block(x, blk, cfg["heads"], cfg["layer_norm_eps"])
    x = _ln(x.float(), params["norm"], cfg["layer_norm_eps"])
    return x[:, 1 + nreg:]


def encode(params: dict, pca: tuple, rgb: torch.Tensor, cfg: dict,
           dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, 3] RGB floats in [0, 1] -> [B, 37, 37, 64] language
    features: antialiased bilinear resize to 518 x 518, ImageNet
    normalisation, DINOv2, per-token L2 normalisation, PCA."""
    size = cfg["image_size"]
    grid = size // cfg["patch_size"]
    x = F.interpolate(rgb.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False,
                      antialias=True).permute(0, 2, 3, 1)
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    feats = dino_forward(params, (x - mean) / std, cfg, dtype)
    feats = feats / torch.linalg.vector_norm(
        feats, dim=-1, keepdim=True).clamp_min(1e-12)
    mean_pca, comps = pca
    lf = (feats - mean_pca) @ comps.T
    return lf.reshape(rgb.shape[0], grid, grid, -1)
