"""Shallow MLP autoencoder 768->64->768 (the legacy compressor).

Counterpart of legslam_tpu/models/autoencoder.py. The reference's earlier
pipeline compressed OpenSeg features with a shallow autoencoder instead of
PCA (embeddings_encoder/pixelwise_decoder.py, referenced by
cfg/encoder/ckpts_text_scannet_20_ae_shallow.yaml). encode() is a drop-in
alternative to pca.apply_pca, and `train_autoencoder` fits it from a
feature corpus on the device with Adam.
"""
from __future__ import annotations

import math
from typing import Iterable, NamedTuple

import numpy as np
import torch


class AEParams(NamedTuple):
    enc_w: torch.Tensor  # [D, K]
    enc_b: torch.Tensor  # [K]
    dec_w: torch.Tensor  # [K, D]
    dec_b: torch.Tensor  # [D]


def params_from_numpy(params, device: str | torch.device = "cuda"
                      ) -> AEParams:
    """The port's AEParams from a JAX AEParams (or any 4-sequence in its
    field order) of arrays: float32 tensors on `device`."""
    return AEParams(*(torch.tensor(np.asarray(a, np.float32), device=device)
                      for a in params))


def init(generator: torch.Generator, d: int = 768, k: int = 64,
         device: str | torch.device = "cuda") -> AEParams:
    """Uniform(-1/sqrt(d), 1/sqrt(d)) weights drawn from `generator` on its
    own device, zero biases, on `device`."""
    s = 1.0 / math.sqrt(d)

    def uniform(*shape):
        u = torch.rand(*shape, generator=generator, device=generator.device)
        return ((u * 2.0 - 1.0) * s).to(device)
    return AEParams(enc_w=uniform(d, k), enc_b=torch.zeros(k, device=device),
                    dec_w=uniform(k, d), dec_b=torch.zeros(d, device=device))


def encode(params: AEParams, x: torch.Tensor) -> torch.Tensor:
    return x @ params.enc_w + params.enc_b


def decode(params: AEParams, z: torch.Tensor) -> torch.Tensor:
    return z @ params.dec_w + params.dec_b


def train_autoencoder(feature_batches: Iterable[np.ndarray],
                      generator: torch.Generator, d: int = 768, k: int = 64,
                      lr: float = 1e-3, epochs: int = 5,
                      device: str | torch.device = "cuda") -> AEParams:
    """MSE-reconstruction training with Adam (pixelwise_decoder semantics;
    torch.optim.Adam has optax.adam's defaults), every batch every epoch."""
    params = [p.requires_grad_() for p in init(generator, d, k, device)]
    opt = torch.optim.Adam(params, lr=lr)
    batches = [torch.as_tensor(np.asarray(b), dtype=torch.float32,
                               device=device) for b in feature_batches]
    p = AEParams(*params)
    for _ in range(epochs):
        for b in batches:
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((decode(p, encode(p, b)) - b) ** 2)
            loss.backward()
            opt.step()
    return AEParams(*(t.detach() for t in params))
