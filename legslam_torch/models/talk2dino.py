"""Talk2DINO text branch: CLIP-text -> DINOv2-space projection -> PCA-64.

Counterpart of legslam_tpu/models/talk2dino.py, the reference's
open-vocabulary text pipeline (eval/utils.py:87-111 +
eval/open_vocabulary_segmentation/models/dinotext/dinotext.py:225-276 +
model.py:303-313):

  1. 7 prompt templates per category -> CLIP token ids,
  2. CLIP ViT-B/16 encode_text per template,
  3. mean over templates,
  4. ProjectionLayer: Linear(512->768) then [tanh -> Linear(768->768)]
     (weights: the reference's weights/vitb_mlp_infonce.pth),
  5. L2 normalize,
  6. PCA compress 768 -> 64 (the same PCA as the per-frame features).

The port has no tokenizer (models/clip_text.tokenize raises), so
build_text_embedding takes the token ids.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from legslam_torch.models import clip_text as CT
from legslam_torch.models import pca as PCA

TEMPLATES = (
    "itap of a {}.",
    "a bad photo of a {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
)


class ProjectionParams(NamedTuple):
    linear_w: torch.Tensor    # [512, 768] (kernel, input-major)
    linear_b: torch.Tensor    # [768]
    hidden_ws: tuple          # each [768, 768]
    hidden_bs: tuple          # each [768]


def params_from_numpy(proj, device: str | torch.device = "cuda"
                      ) -> ProjectionParams:
    """The port's ProjectionParams on `device` from a ProjectionParams of
    arrays (the JAX package's, or the talk2dino_proj.npz tree's)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return ProjectionParams(
        linear_w=t(proj.linear_w), linear_b=t(proj.linear_b),
        hidden_ws=tuple(t(w) for w in proj.hidden_ws),
        hidden_bs=tuple(t(b) for b in proj.hidden_bs))


def load_projection(path: str, device: str | torch.device = "cuda"
                    ) -> ProjectionParams:
    """Read the reference checkpoint (weights/vitb_mlp_infonce.pth layout:
    linear_layer.{weight,bias}, hidden_layers.N.{weight,bias})."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    hidden_ws, hidden_bs = [], []
    i = 0
    while f"hidden_layers.{i}.weight" in sd:
        hidden_ws.append(sd[f"hidden_layers.{i}.weight"].numpy().T)
        hidden_bs.append(sd[f"hidden_layers.{i}.bias"].numpy())
        i += 1
    return params_from_numpy(ProjectionParams(
        linear_w=sd["linear_layer.weight"].numpy().T,
        linear_b=sd["linear_layer.bias"].numpy(),
        hidden_ws=hidden_ws, hidden_bs=hidden_bs), device)


def init_projection(generator: torch.Generator, clip_dim: int = 512,
                    dino_dim: int = 768, hidden: int = 1,
                    device: str | torch.device = "cuda") -> ProjectionParams:
    """Random-init projection drawn from `generator` on its own device."""
    def randn(*shape):
        return (torch.randn(*shape, generator=generator,
                            device=generator.device) * 0.02).to(device)
    return ProjectionParams(
        linear_w=randn(clip_dim, dino_dim),
        linear_b=torch.zeros(dino_dim, device=device),
        hidden_ws=tuple(randn(dino_dim, dino_dim) for _ in range(hidden)),
        hidden_bs=tuple(torch.zeros(dino_dim, device=device)
                        for _ in range(hidden)))


def project_clip_text(proj: ProjectionParams,
                      emb: torch.Tensor) -> torch.Tensor:
    """model.py:303-313: linear, then per hidden layer tanh -> linear."""
    x = emb @ proj.linear_w + proj.linear_b
    for w, b in zip(proj.hidden_ws, proj.hidden_bs):
        x = torch.tanh(x)
        x = x @ w + b
    return x


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def build_text_embedding(categories: Sequence[str], clip_params: dict,
                         proj: ProjectionParams,
                         pca: Optional[PCA.PCAParams],
                         tokens=None,
                         clip_cfg: Optional[CT.ClipTextConfig] = None
                         ) -> torch.Tensor:
    """[N_categories, 64] compressed text embeddings (eval/utils.py:87-111)
    on the CLIP parameters' device. `tokens` [N, 7, 77] are the token ids
    of each category's templates; without them the tokenizer is asked and
    raises (models/clip_text.tokenize)."""
    n = len(categories)
    t = len(TEMPLATES)
    if tokens is None:
        tokens = CT.tokenize([tpl.format(c) for c in categories
                              for tpl in TEMPLATES])
    tokens = torch.as_tensor(tokens).reshape(n * t, -1)
    emb = CT.encode_text(clip_params, tokens, clip_cfg)   # [n*t, 512]
    emb = emb.reshape(n, t, -1).mean(1)                   # template average
    emb = _l2n(project_clip_text(proj, emb))              # [n, 768]
    if pca is not None:
        emb = PCA.apply_pca(pca, emb)                     # [n, 64]
    return emb


def cosine_heatmap(lf_image: torch.Tensor, text_emb: torch.Tensor,
                   invert: bool = True) -> torch.Tensor:
    """Per-pixel cosine similarity between a rendered LF image [H, W, 64]
    and text embeddings [N, 64] -> [N, H, W].

    `invert=True` applies the eval-side min-max inversion
    (1 - minmax(cos)): the training loss ADDS cosine similarity, so high
    relevance = low raw cosine, and every consumer inverts
    (eval/find_objects.py:302-303, eval/render_object.py:93).
    """
    sim = torch.einsum("hwc,nc->nhw", _l2n(lf_image), _l2n(text_emb))
    if not invert:
        return sim
    lo = sim.amin(dim=(1, 2), keepdim=True)
    hi = sim.amax(dim=(1, 2), keepdim=True)
    return 1.0 - (sim - lo) / torch.clamp_min(hi - lo, 1e-12)


def build_image_embedding(clip_vision_params: dict,
                          proj: Optional[ProjectionParams],
                          pca: Optional[PCA.PCAParams],
                          rgb, vision_cfg=None) -> torch.Tensor:
    """Image-as-query embedding, the reference pipeline (eval/utils.py:
    113-171): 224px resize + CLIP normalization -> CLIP vision tower
    (class-token pooled 512-D) -> the same Talk2DINO projection as text ->
    L2 normalize -> PCA compress -> [64], on the parameters' device.
    `rgb` is an [H, W, 3] float image in [0, 1], array or tensor."""
    from legslam_torch.models import clip_vision as CV
    dev = clip_vision_params["patch_kernel"].device
    x = CV.preprocess(torch.as_tensor(rgb, device=dev), vision_cfg)
    emb = CV.encode_image(clip_vision_params, x, vision_cfg)   # [1, 512]
    if proj is not None:
        emb = project_clip_text(proj, emb)                     # [1, 768]
    emb = _l2n(emb)
    if pca is not None:
        emb = PCA.apply_pca(pca, emb)
    return emb[0]
