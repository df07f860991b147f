"""Capacity-padded Gaussian parameter store with Adam.

Counterpart of legslam_tpu/models/gaussians.py (reference GaussianModel,
src/gaussian_model.cpp). The store keeps a fixed capacity and a validity
mask, like the JAX package, so a state converted from it drives the port
row for row:

  * 7 parameter groups in the reference order xyz / f_dc / f_rest /
    lang_feat / opacity / scaling / rotation (gaussian_model.cpp:533-541),
  * activations exp / sigmoid / normalize (gaussian_model.cpp:46-68),
  * create_from_pcd (knn scale init, opacity inverse_sigmoid(0.1),
    identity quat; gaussian_model.cpp:109-194),
  * torch-Adam-exact updates with eps=1e-15 and one step count shared by
    all groups (gaussian_model.cpp:488-511),
  * densify stats (accumulated ||dL/dmean2D.xy||, gaussian_model.cpp:834-847).

Unlike the JAX package, Adam and the densify statistics update the state's
tensors in place (no copy of the store per step).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from legslam_torch.config import (
    INIT_OPACITY,
    KNN_DIST_CLAMP,
    LF_CHANNELS,
    SH_COEFFS_MAX,
)
from legslam_torch.utils.knn import mean_sq_dist_to_3nn
from legslam_torch.utils.sh import rgb_to_sh
from legslam_torch.utils.transforms import inverse_sigmoid, normalize_quat

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # gaussian_model.cpp trainingSetup eps

GROUPS = ("xyz", "f_dc", "f_rest", "lang_feat", "opacity", "scaling",
          "rotation")
STATS = ("grad_accum", "denom", "max_radii2d")


@dataclasses.dataclass
class GaussianParams:
    """The 7 optimizable groups, capacity-padded along the leading axis."""
    xyz: torch.Tensor        # [C, 3]
    f_dc: torch.Tensor       # [C, 1, 3] SH DC
    f_rest: torch.Tensor     # [C, 15, 3] higher SH
    lang_feat: torch.Tensor  # [C, LF]
    opacity: torch.Tensor    # [C, 1] raw (pre-sigmoid)
    scaling: torch.Tensor    # [C, 3] log scales
    rotation: torch.Tensor   # [C, 4] wxyz quats (normalized on use)

    def as_dict(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in GROUPS}


@dataclasses.dataclass
class DensifyStats:
    grad_accum: torch.Tensor   # [C] accumulated ||dL/dmean2D.xy|| (NDC conv.)
    denom: torch.Tensor        # [C] visit counts
    max_radii2d: torch.Tensor  # [C] running max screen radius


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    valid: torch.Tensor        # [C] bool
    exist_since: torch.Tensor  # [C] int32 creation iteration
    adam_m: GaussianParams
    adam_v: GaussianParams
    adam_step: torch.Tensor    # [] int32, shared across groups
    stats: DensifyStats
    overflow_dropped: torch.Tensor  # [] int32: points lost to capacity

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def scales(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity[:, 0])

    def rotations(self) -> torch.Tensor:
        return normalize_quat(self.params.rotation)

    def sh(self) -> torch.Tensor:
        return torch.cat([self.params.f_dc, self.params.f_rest], dim=1)


def _zeros_params(capacity: int, device) -> GaussianParams:
    def z(*shape):
        return torch.zeros((capacity,) + shape, dtype=torch.float32,
                           device=device)
    rotation = z(4)
    rotation[:, 0] = 1.0
    return GaussianParams(xyz=z(3), f_dc=z(1, 3), f_rest=z(SH_COEFFS_MAX - 1, 3),
                          lang_feat=z(LF_CHANNELS), opacity=z(1), scaling=z(3),
                          rotation=rotation)


def empty(capacity: int, device: str | torch.device = "cuda") -> GaussianState:
    params = _zeros_params(capacity, device)

    def zero_moments():
        # true zeros (torch.optim.Adam exp_avg init), not the identity quat
        return GaussianParams(**{k: torch.zeros_like(v)
                                 for k, v in params.as_dict().items()})

    def z(dtype):
        return torch.zeros(capacity, dtype=dtype, device=device)
    return GaussianState(
        params=params, valid=z(torch.bool), exist_since=z(torch.int32),
        adam_m=zero_moments(), adam_v=zero_moments(),
        adam_step=torch.zeros((), dtype=torch.int32, device=device),
        stats=DensifyStats(grad_accum=z(torch.float32),
                           denom=z(torch.float32),
                           max_radii2d=z(torch.float32)),
        overflow_dropped=torch.zeros((), dtype=torch.int32, device=device))


def _new_point_params(points: torch.Tensor, colors: torch.Tensor,
                      lang_feat: torch.Tensor | None) -> GaussianParams:
    """SH DC from RGB, f_rest zero, scale log(sqrt(mean 3-NN sq dist)),
    identity quat, opacity inverse_sigmoid(0.1)
    (gaussian_model.cpp:140-167)."""
    n = points.shape[0]
    dev = points.device
    dist2 = torch.clamp_min(mean_sq_dist_to_3nn(points), KNN_DIST_CLAMP)
    scaling = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    if lang_feat is None:
        lang_feat = torch.zeros(n, LF_CHANNELS, device=dev)
    rotation = torch.zeros(n, 4, device=dev)
    rotation[:, 0] = 1.0
    opacity = inverse_sigmoid(torch.tensor(INIT_OPACITY, dtype=torch.float32))
    return GaussianParams(
        xyz=points, f_dc=rgb_to_sh(colors)[:, None, :],
        f_rest=torch.zeros(n, SH_COEFFS_MAX - 1, 3, device=dev),
        lang_feat=lang_feat,
        opacity=torch.full((n, 1), float(opacity), device=dev),
        scaling=scaling, rotation=rotation)


def create_from_pcd(points, colors, capacity: int, lang_feat=None,
                    device: str | torch.device = "cuda") -> GaussianState:
    """Initialize the store from a colored point cloud
    (gaussian_model.cpp:109-194). points/colors [N, 3], N <= capacity."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=device)
    if lang_feat is not None:
        lang_feat = torch.as_tensor(lang_feat, dtype=torch.float32,
                                    device=device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    state = empty(capacity, device)
    new = _new_point_params(points, colors, lang_feat)
    for name in GROUPS:
        getattr(state.params, name)[:n] = getattr(new, name)
    state.valid[:n] = True
    return state


@torch.no_grad()
def adam_update(state: GaussianState, grads: GaussianParams,
                lrs: dict[str, Any]) -> GaussianState:
    """One Adam step over all 7 groups with per-group learning rates, in
    place. Matches torch.optim.Adam: m, v EMA + bias correction, denom =
    sqrt(v / bc2) + eps, update = lr / bc1 * m / denom. Invalid slots get
    zero grads upstream, so their moments only decay."""
    state.adam_step += 1
    t = state.adam_step.to(torch.float32)
    bc1 = 1.0 - torch.pow(ADAM_B1, t)
    bc2 = 1.0 - torch.pow(ADAM_B2, t)
    for name in GROUPS:
        p = getattr(state.params, name)
        g = getattr(grads, name)
        m = getattr(state.adam_m, name)
        v = getattr(state.adam_v, name)
        m.copy_(ADAM_B1 * m + (1.0 - ADAM_B1) * g)
        v.copy_(ADAM_B2 * v + (1.0 - ADAM_B2) * g * g)
        denom = torch.sqrt(v / bc2) + ADAM_EPS
        p.sub_((lrs[name] / bc1) * m / denom)
    return state


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000
             ) -> torch.Tensor:
    """Plenoxels/JaxNeRF log-lerp schedule (gaussian_model.cpp:1143-1156),
    as a float32 tensor on the device of `step` (CPU for a number).
    Returns 0 when step < 0 or both lrs are 0."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * np.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    tt = torch.clamp(step / max_steps, 0.0, 1.0)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    log_lerp = torch.exp(
        torch.log(torch.tensor(lr_init, dtype=torch.float32)) * (1 - tt)
        + torch.log(torch.tensor(lr_final, dtype=torch.float32)) * tt)
    return torch.where(step >= 0, delay_rate * log_lerp, 0.0)


@torch.no_grad()
def add_densification_stats(state: GaussianState, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate ||dL/dmean2D.xy||2 and visit counts for visible
    gaussians (radii > 0), and the running max screen radius, in place
    (gaussian_model.cpp:834-847, gaussian_mapper.cpp:739-747)."""
    visible = radii > 0
    norm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    st = state.stats
    st.grad_accum.add_(torch.where(visible, norm, 0.0))
    st.denom.add_(visible.to(torch.float32))
    torch.maximum(st.max_radii2d,
                  torch.where(visible, radii.to(torch.float32), 0.0),
                  out=st.max_radii2d)
    return state


def state_from_numpy(tree: dict, device: str | torch.device = "cuda"
                     ) -> GaussianState:
    """A GaussianState from the nested numpy layout of
    legslam_tpu/mapper/checkpoint.py:29-40 (params / adam_m / adam_v of
    the 7 groups, valid, exist_since, adam_step, stats,
    overflow_dropped), so a JAX state or checkpoint drives the port."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def params(d):
        return GaussianParams(**{n: t(d[n], torch.float32) for n in GROUPS})

    return GaussianState(
        params=params(tree["params"]), valid=t(tree["valid"], torch.bool),
        exist_since=t(tree["exist_since"], torch.int32),
        adam_m=params(tree["adam_m"]), adam_v=params(tree["adam_v"]),
        adam_step=t(tree["adam_step"], torch.int32),
        stats=DensifyStats(**{n: t(tree["stats"][n], torch.float32)
                              for n in STATS}),
        overflow_dropped=t(tree["overflow_dropped"], torch.int32))


def state_to_numpy(state: GaussianState) -> dict:
    """The inverse of state_from_numpy (checkpoint layout, numpy arrays).
    The arrays are copies: the state's tensors are updated in place."""
    def a(x):
        return np.array(x.detach().cpu())

    def params(p):
        return {n: a(getattr(p, n)) for n in GROUPS}

    return dict(
        params=params(state.params), adam_m=params(state.adam_m),
        adam_v=params(state.adam_v), valid=a(state.valid),
        exist_since=a(state.exist_since), adam_step=a(state.adam_step),
        stats={n: a(getattr(state.stats, n)) for n in STATS},
        overflow_dropped=a(state.overflow_dropped))
