"""CLIP ViT-B/16 vision encoder (the image-as-query tower).

Counterpart of legslam_tpu/models/clip_vision.py (the reference's
`clip_model.encode_image`, eval/utils.py:113-171: 224px resize + CLIP
normalization -> vision transformer -> class-token pooling -> visual
projection 768->512, after which the embedding rides the same Talk2DINO
projection + PCA as text).

Architecture (OpenAI CLIP VisionTransformer): 16x16 patch embedding (no
bias), class token, learned position embeddings (197), pre-LN, 12 layers
x width 768 x 12 heads with quick-GELU MLPs, ln_post on the class token,
then the visual projection. The block is clip_text._block with no mask.
Parameters are the JAX package's layout: the patch embedding is a
[p*p*3, width] matmul kernel over patches flattened in (py, px, c) order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from legslam_torch.models.clip_text import (_block, _f32, _hf_blocks, _ln,
                                            _openai_blocks,
                                            params_from_numpy)

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    proj_dim: int = 512
    eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1


def init_params(cfg: ClipVisionConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random-init parameters (shapes == converted checkpoints), drawn
    from `generator` on its own device and moved to `device`."""
    def randn(*shape, std=0.02):
        return (torch.randn(*shape, generator=generator,
                            device=generator.device) * std).to(device)

    def norm(n):
        return dict(scale=torch.ones(n, device=device),
                    bias=torch.zeros(n, device=device))

    def dense(din, dout):
        return dict(kernel=randn(din, dout),
                    bias=torch.zeros(dout, device=device))

    def block():
        w = cfg.width
        return dict(ln1=norm(w), qkv=dense(w, 3 * w), proj=dense(w, w),
                    ln2=norm(w), fc1=dense(w, 4 * w), fc2=dense(4 * w, w))

    return dict(
        patch_kernel=randn(cfg.patch * cfg.patch * 3, cfg.width),
        class_embedding=randn(cfg.width),
        pos_embedding=randn(cfg.tokens, cfg.width, std=0.01),
        ln_pre=norm(cfg.width),
        blocks=[block() for _ in range(cfg.layers)],
        ln_post=norm(cfg.width),
        visual_projection=randn(cfg.width, cfg.proj_dim))


def preprocess(rgb, cfg: Optional[ClipVisionConfig] = None) -> torch.Tensor:
    """[H, W, 3] float in [0, 1] -> [1, S, S, 3] CLIP-normalized
    (eval/utils.py:132-138: Resize(224) + Normalize), on the tensor's
    device (the CPU for an array). The JAX module's
    jax.image.resize(..., "linear") antialiases when it shrinks: torch's
    bilinear with antialias=True."""
    cfg = cfg or ClipVisionConfig()
    s = cfg.image_size
    x = torch.as_tensor(rgb, dtype=torch.float32)
    x = F.interpolate(x.permute(2, 0, 1)[None], size=(s, s), mode="bilinear",
                      align_corners=False, antialias=True)
    x = x.permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def encode_image(params: dict, images: torch.Tensor,
                 cfg: Optional[ClipVisionConfig] = None) -> torch.Tensor:
    """images [B, S, S, 3] (CLIP-normalized, channel-last) -> [B, proj_dim]
    embeddings (class-token pooled + projected, like CLIP.encode_image),
    on the parameters' device."""
    cfg = cfg or ClipVisionConfig()
    dev = params["patch_kernel"].device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    b = images.shape[0]
    g, p, w = cfg.grid, cfg.patch, cfg.width
    # patches flattened in (py, px, c) order, then one matmul, as in JAX
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, p * p * 3) @ params["patch_kernel"]
    cls = params["class_embedding"].expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"]
    x = _ln(x, params["ln_pre"], cfg.eps)
    mask = torch.zeros((1, 1, cfg.tokens, cfg.tokens), device=dev)
    for blk in params["blocks"]:
        x = _block(x, blk, cfg.heads, cfg.eps, mask)
    pooled = _ln(x[:, 0], params["ln_post"], cfg.eps)
    return pooled @ params["visual_projection"]


def _conv_to_kernel(wconv) -> np.ndarray:
    """torch Conv2d weight [width, 3, p, p] -> the [p*p*3, width] matmul
    kernel of encode_image's (py, px, c) patch flattening."""
    w = _f32(wconv)
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


def convert_openai(sd: dict, cfg: Optional[ClipVisionConfig] = None,
                   device: str | torch.device = "cuda") -> dict:
    """OpenAI CLIP full-model state dict -> vision-branch parameters on
    `device`."""
    cfg = cfg or ClipVisionConfig()
    sd = {k: np.asarray(v) for k, v in sd.items()}
    return params_from_numpy(dict(
        patch_kernel=_conv_to_kernel(sd["visual.conv1.weight"]),
        class_embedding=_f32(sd["visual.class_embedding"]),
        pos_embedding=_f32(sd["visual.positional_embedding"]),
        ln_pre=dict(scale=_f32(sd["visual.ln_pre.weight"]),
                    bias=_f32(sd["visual.ln_pre.bias"])),
        blocks=_openai_blocks(sd, "visual.transformer.resblocks.",
                              cfg.layers),
        ln_post=dict(scale=_f32(sd["visual.ln_post.weight"]),
                     bias=_f32(sd["visual.ln_post.bias"])),
        visual_projection=_f32(sd["visual.proj"])), device)


def convert_hf(sd: dict, proj: Optional[np.ndarray] = None,
               cfg: Optional[ClipVisionConfig] = None,
               device: str | torch.device = "cuda") -> dict:
    """HF CLIPVisionModel(WithProjection) state dict -> parameters on
    `device`."""
    cfg = cfg or ClipVisionConfig()
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if proj is None and "visual_projection.weight" in sd:
        proj = sd["visual_projection.weight"].T
    if proj is None:
        proj = np.eye(cfg.width, cfg.proj_dim, dtype=np.float32)
    vm = "vision_model."
    return params_from_numpy(dict(
        patch_kernel=_conv_to_kernel(
            sd[vm + "embeddings.patch_embedding.weight"]),
        class_embedding=_f32(sd[vm + "embeddings.class_embedding"]),
        pos_embedding=_f32(sd[vm + "embeddings.position_embedding.weight"]),
        ln_pre=dict(scale=_f32(sd[vm + "pre_layrnorm.weight"]),
                    bias=_f32(sd[vm + "pre_layrnorm.bias"])),
        blocks=_hf_blocks(sd, vm + "encoder.layers.", cfg.layers),
        ln_post=dict(scale=_f32(sd[vm + "post_layernorm.weight"]),
                     bias=_f32(sd[vm + "post_layernorm.bias"])),
        visual_projection=_f32(proj)), device)
