"""Checkpoint / resume for the full mapper state.

Counterpart of legslam_tpu/mapper/checkpoint.py. The reference's only
checkpoint is the PLY + sidecars (no optimizer state; SURVEY.md §5); this
is a real one: the complete GaussianState (params + valid mask +
exist_since + Adam moments + densify stats) as one .npz in the JAX
module's layout (models/weights_io.py keys, models/gaussians.py
state_to_numpy), so a checkpoint written by either package loads in the
other, plus an optional <path>.meta.json.
"""
from __future__ import annotations

import json
import os

import torch

from legslam_torch.models import gaussians as G
from legslam_torch.models.weights_io import load_params, save_params


def save_checkpoint(path: str, state: G.GaussianState,
                    meta: dict | None = None) -> None:
    save_params(path, G.state_to_numpy(state))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path: str, device: str | torch.device = "cuda"
                    ) -> tuple[G.GaussianState, dict]:
    state = G.state_from_numpy(load_params(path), device)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state, meta


def state_from_ply(ply_path: str, capacity: int,
                   device: str | torch.device = "cuda") -> G.GaussianState:
    """Resume from the reference-compatible PLY export (loadPly,
    gaussian_model.cpp:854-970 / eval/gaussian_model.py:59-111): params
    restored, Adam moments zeroed."""
    from legslam_torch.utils.ply import load_gaussian_ply
    raw = load_gaussian_ply(ply_path)
    n = raw["xyz"].shape[0]
    if n > capacity:
        raise ValueError(f"PLY has {n} gaussians > capacity {capacity}")
    st = G.empty(capacity, device)
    for name in G.GROUPS:
        getattr(st.params, name)[:n] = torch.as_tensor(
            raw[name], dtype=torch.float32, device=device)
    st.valid[:n] = True
    return st
