"""Model weight persistence.

Counterpart of legslam_tpu/models/weights_io.py: model parameters persist
as flat .npz archives whose keys are the tree paths joined by "/"
("blocks/0/qkv/kernel"), the JAX module's layout, so an archive written by
either package loads in both. `tools/convert_weights.py` converts the
reference's artifacts into this layout.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def flatten(tree: Any, prefix: str = "") -> dict:
    """{"a/0/b": numpy array} of a nested dict / list tree of tensors or
    arrays."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten(flat: dict) -> Any:
    """The inverse of flatten: a tree of numpy arrays, a node whose keys
    are all digits becoming a list."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_params(path: str, params: Any) -> None:
    np.savez(path, **flatten(params))


def load_params(path: str) -> Any:
    """The parameter tree of an .npz archive, as numpy arrays."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def load_encoder(weights_dir: str, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", cfg=None):
    """A LanguageFeaturesEncoder from <dir>/dinov2.npz + <dir>/pca.npz, on
    `device`. `cfg` (a DinoV2Config) defaults to ViT-B/14-reg."""
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import pca as PCA
    from legslam_torch.models.encoder import LanguageFeaturesEncoder

    dino = D.params_from_numpy(
        load_params(os.path.join(weights_dir, "dinov2.npz")), device)
    pca = PCA.load(os.path.join(weights_dir, "pca.npz"), device)
    return LanguageFeaturesEncoder(dino, pca, cfg, dtype=dtype, device=device)


def load_text_pipeline(weights_dir: str):
    """(clip_params, projection, pca): needs models/clip_text.py and
    models/talk2dino.py, which are not ported yet."""
    raise NotImplementedError(
        "load_text_pipeline: the CLIP text / Talk2DINO query stack is not "
        "ported to legslam_torch yet; see ROADMAP.md")


def load_image_pipeline(weights_dir: str):
    """(clip_vision_params, projection, pca): needs models/clip_vision.py,
    which is not ported yet."""
    raise NotImplementedError(
        "load_image_pipeline: the CLIP vision query stack is not ported to "
        "legslam_torch yet; see ROADMAP.md")
