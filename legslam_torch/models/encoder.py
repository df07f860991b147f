"""LanguageFeaturesEncoder: per-frame RGB -> 37x37x64 language features.

Counterpart of legslam_tpu/models/encoder.py (the reference's ONNX
pipeline, src/language_features_encoder.cpp + encoder_models.cpp +
compressor_models.cpp): resize to 518x518, /255 + ImageNet normalize,
DINOv2 ViT-B/14-reg forward -> x_norm_patchtokens [1369, 768], per-token L2
normalization (encoder_models.cpp:109-112), PCA matmul to 64-D
(compressor_models.cpp:69-98), reshape to the 37x37 64-channel feature
image (language_features_encoder.cpp:83-89). The result stays on the
encoder's device, where the mapper's keyframes keep it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from legslam_torch.config import IMAGENET_MEAN, IMAGENET_STD
from legslam_torch.models import dinov2 as D
from legslam_torch.models import pca as PCA
from legslam_torch.utils import runtime


class LanguageFeaturesEncoder:
    """The reference factory reads Encoder.Type + PixelwiseCompressor.Type
    from cfg/encoder/*.yaml; this takes the parameters directly. `dtype`
    has the meaning of models/dinov2.py (bfloat16: bf16 weights, float32
    arithmetic); the block parameters are rounded to it once, here."""

    def __init__(self, dino_params: dict, pca_params: PCA.PCAParams,
                 cfg: Optional[D.DinoV2Config] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or D.DinoV2Config()
        self.device = torch.device(device)
        self.dtype = dtype
        self.dino_params = D.tree_map(lambda t: t.to(self.device),
                                      dino_params)
        self.pca_params = PCA.PCAParams(*(t.to(self.device)
                                          for t in pca_params))
        self._cast_params = D.cast_blocks(self.dino_params, dtype)
        # on the device once: a per-call host-to-device copy of the
        # constants would block the host until the card caught up
        self._norm = tuple(torch.tensor(c, device=self.device)
                           for c in (IMAGENET_MEAN, IMAGENET_STD))

    def _input(self, rgb) -> torch.Tensor:
        x = torch.as_tensor(rgb, device=self.device)
        return x if x.dtype == torch.uint8 else x.float()

    @runtime.spanned("encoder")
    @torch.no_grad()
    def create_language_features(self, rgb) -> torch.Tensor:
        """[H, W, 3] RGB, float in [0,1] or uint8 (numpy or tensor) ->
        [37, 37, 64] float32 on the encoder's device
        (LanguageFeaturesEncoder::createLanguageFeatures contract)."""
        return self.encode_batch(self._input(rgb)[None])[0]

    @torch.no_grad()
    def encode_batch(self, rgb) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 37, 37, 64]."""
        return encode(self._cast_params, self.pca_params, self._input(rgb),
                      self.cfg, self.dtype, self._norm)


def encode(dino_params: dict, pca_params: PCA.PCAParams, rgb: torch.Tensor,
           cfg: D.DinoV2Config, dtype: torch.dtype,
           norm: tuple) -> torch.Tensor:
    """The JAX module's `_encode` on parameters passed through
    dinov2.cast_blocks: [B, H, W, 3] -> [B, G, G, K]. `norm` is the
    ImageNet (mean, std) on rgb's device."""
    b = rgb.shape[0]
    size = cfg.image_size
    grid = size // cfg.patch_size
    if rgb.dtype == torch.uint8:
        rgb = rgb.float() / 255.0
    if tuple(rgb.shape[1:3]) != (size, size):
        # jax.image.resize(..., "linear") antialiases when it shrinks
        rgb = F.interpolate(rgb.permute(0, 3, 1, 2), size=(size, size),
                            mode="bilinear", align_corners=False,
                            antialias=True).permute(0, 2, 3, 1)
    x = D.imagenet_normalize(rgb, *norm)
    feats = D.forward_cast(dino_params, x, cfg, dtype)   # [B, G*G, 768]
    feats = feats / torch.linalg.vector_norm(
        feats, dim=-1, keepdim=True).clamp_min(1e-12)
    lf = PCA.apply_pca(pca_params, feats)                  # [B, G*G, 64]
    return lf.reshape(b, grid, grid, -1)
