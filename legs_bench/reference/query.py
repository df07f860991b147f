"""Plain reference of the open-vocabulary query: the CLIP ViT-B/16 text
tower, the Talk2DINO projection, the PCA and the gaussian-space search,
in plain torch and numpy. Frozen copies of
legslam_torch/models/clip_text.py:77-128 (encode_text),
models/talk2dino.py:91-126 (projection, template mean, normalisation,
PCA) and eval_harness/find_objects.py:34-44, 309-336 (inverted
similarity, threshold, clusters), taking the weights the benchmark made.
The clustering takes DBSCAN from scikit-learn where it is installed and
one cluster where it is not, as the search does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SIM_THRESHOLD = 0.94
DBSCAN_EPS = 0.16
DBSCAN_MIN_SAMPLES = 5


def _ln(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _block(x, p, heads, eps, mask):
    b, n, w = x.shape
    hd = w // heads
    y = _ln(x, p["ln1"], eps)
    q, k, v = (y @ p["qkv"]["kernel"] + p["qkv"]["bias"]).split(w, dim=-1)

    def split_heads(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    att = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd) + mask,
                        dim=-1)
    y = (att @ v).transpose(1, 2).reshape(b, n, w)
    x = x + (y @ p["proj"]["kernel"] + p["proj"]["bias"])
    y = _ln(x, p["ln2"], eps)
    y = y @ p["fc1"]["kernel"] + p["fc1"]["bias"]
    y = y * torch.sigmoid(1.702 * y)
    return x + (y @ p["fc2"]["kernel"] + p["fc2"]["bias"])


def encode_text(params: dict, tokens: torch.Tensor, heads: int,
                eps: float) -> torch.Tensor:
    emb = params["token_embedding"]
    tokens = tokens.to(emb.device).long()
    x = emb[tokens] + params["pos_embedding"]
    n = tokens.shape[1]
    mask = torch.triu(torch.full((n, n), float("-inf"), device=emb.device),
                      1)
    for blk in params["blocks"]:
        x = _block(x, blk, heads, eps, mask)
    x = _ln(x, params["ln_final"], eps)
    pooled = x[torch.arange(tokens.shape[0], device=emb.device),
               tokens.argmax(-1)]
    return pooled @ params["text_projection"]


def text_embedding(clip: dict, proj: dict, pca: tuple, tokens: torch.Tensor,
                   heads: int, eps: float) -> torch.Tensor:
    """tokens [N, 7, 77] -> [N, 64]: the mean over a category's template
    embeddings, projected, normalised and compressed."""
    n, t = tokens.shape[:2]
    emb = encode_text(clip, tokens.reshape(n * t, -1), heads, eps)
    x = emb.reshape(n, t, -1).mean(1) @ proj["linear_w"] + proj["linear_b"]
    for w, b in zip(proj["hidden_ws"], proj["hidden_bs"]):
        x = torch.tanh(x) @ w + b
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    mean, comps = pca
    return (x - mean) @ comps.T


def find_objects(xyz: np.ndarray, lang_feat: np.ndarray,
                 text_emb: np.ndarray) -> list:
    """[(center [3], n_gaussians, score)], largest first."""
    lfn = lang_feat / np.linalg.norm(lang_feat, axis=-1,
                                     keepdims=True).clip(1e-12)
    te = text_emb[None] / np.linalg.norm(text_emb).clip(1e-12)
    sim = np.einsum("...c,nc->n...", lfn, te)[0]
    heat = 1.0 - (sim - sim.min()) / np.maximum(sim.max() - sim.min(),
                                                 1e-12)
    sel = heat > SIM_THRESHOLD
    if sel.sum() < DBSCAN_MIN_SAMPLES:
        return []
    pts, scores = xyz[sel], heat[sel]
    try:
        from sklearn.cluster import DBSCAN
        labels = DBSCAN(eps=DBSCAN_EPS,
                        min_samples=DBSCAN_MIN_SAMPLES).fit(pts).labels_
    except ImportError:
        labels = np.zeros(len(pts), np.int64)
    out = []
    for lbl in sorted(set(labels) - {-1}):
        m = labels == lbl
        out.append((pts[m].mean(0), int(m.sum()), float(scores[m].mean())))
    out.sort(key=lambda d: -d[1])
    return out
