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
  * densify stats (accumulated ||dL/dmean2D.xy||, gaussian_model.cpp:834-847),
  * the store surgery of the online mapper: increase_pcd, grow_capacity,
    clone / split / prune with moment surgery (new slots get zero
    moments, pruned slots zero theirs, step preserved;
    gaussian_model.cpp:196-385, 577-832), opacity reset
    (gaussian_model.cpp:567-575) and the loop-closure transforms
    (gaussian_model.cpp:387-481, src/operate_points.cu:93-140).

Unlike the JAX package, Adam and the densify statistics update the state's
tensors in place (no copy of the store per step). The surgery is episodic
and returns a new state, leaving the one it was given as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from legslam_torch.config import (
    INIT_OPACITY,
    KNN_DIST_CLAMP,
    LF_CHANNELS,
    NEAR_CLIP,
    SH_COEFFS_MAX,
)
from legslam_torch.utils.knn import mean_sq_dist_to_3nn
from legslam_torch.utils.sh import rgb_to_sh
from legslam_torch.utils.transforms import (
    inverse_sigmoid,
    normalize_quat,
    quat_to_rotmat,
)

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
                      lang_feat: torch.Tensor | None,
                      point_valid: torch.Tensor | None = None
                      ) -> GaussianParams:
    """SH DC from RGB, f_rest zero, scale log(sqrt(mean 3-NN sq dist)),
    identity quat, opacity inverse_sigmoid(0.1)
    (gaussian_model.cpp:140-167, 236-255). `point_valid` masks padded rows
    out of the 3-NN neighbour pool, so a padded batch gives the real rows
    the params of an unpadded call."""
    n = points.shape[0]
    dev = points.device
    dist2 = torch.clamp_min(mean_sq_dist_to_3nn(points, valid=point_valid),
                            KNN_DIST_CLAMP)
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


def slab_rows(state: GaussianState, n_slabs: int,
              watermark_hint: int | None) -> int:
    """Rows the slab-skipped updates touch: the whole-slab prefix covering
    the live watermark (ops/slabs.py), or every row without slabs."""
    cap = state.capacity
    if not n_slabs or cap % n_slabs:
        return cap
    from legslam_torch.ops.slabs import prefix_rows, watermark
    hi = watermark(state.valid) if watermark_hint is None else watermark_hint
    return prefix_rows(hi, cap, n_slabs)


@torch.no_grad()
def adam_update(state: GaussianState, grads: GaussianParams,
                lrs: dict[str, Any], n_slabs: int = 0,
                watermark_hint: int | None = None) -> GaussianState:
    """One Adam step over all 7 groups with per-group learning rates, in
    place. Matches torch.optim.Adam: m, v EMA + bias correction, denom =
    sqrt(v / bc2) + eps, update = lr / bc1 * m / denom. Invalid slots get
    zero grads upstream, so their moments only decay.

    n_slabs > 0: the watermark slab skip (ops/slabs.py), exact because
    the rows above the live watermark are invalid with zero moments and
    zero grads, fixed points of the update. `watermark_hint` is the
    watermark if the caller knows it on the host (else one read)."""
    m_rows = slab_rows(state, n_slabs, watermark_hint)
    state.adam_step += 1
    t = state.adam_step.to(torch.float32)
    bc1 = 1.0 - torch.pow(ADAM_B1, t)
    bc2 = 1.0 - torch.pow(ADAM_B2, t)
    for name in GROUPS:
        p = getattr(state.params, name)[:m_rows]
        g = getattr(grads, name)[:m_rows]
        m = getattr(state.adam_m, name)[:m_rows]
        v = getattr(state.adam_v, name)[:m_rows]
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
                            radii: torch.Tensor, n_slabs: int = 0,
                            watermark_hint: int | None = None
                            ) -> GaussianState:
    """Accumulate ||dL/dmean2D.xy||2 and visit counts for visible
    gaussians (radii > 0), and the running max screen radius, in place
    (gaussian_model.cpp:834-847, gaussian_mapper.cpp:739-747): one view's
    densification_increments, a batch of one.

    n_slabs > 0: the watermark slab skip, exact because the rows above
    the watermark are invalid and render with radius 0 (not visible), so
    their statistics are fixed points of the accumulation."""
    m = slab_rows(state, n_slabs, watermark_hint)
    return apply_densification_increments(state, *densification_increments(
        mean2d_grad[None, :m], radii[None, :m]))


@torch.no_grad()
def densification_increments(mean2d_grads: torch.Tensor,
                             radii: torch.Tensor):
    """The multi-view statistics' increments of a batch of B views:
    (sum over views of ||dL/dmean2D.xy||2 where visible, visit counts, max
    visible radius), each [P]. mean2d_grads [B, P, 2] must already be
    un-scaled by the 1/B of the loss mean; radii [B, P]."""
    visible = radii > 0
    norm = torch.linalg.norm(mean2d_grads[..., :2], dim=-1)
    return (torch.where(visible, norm, 0.0).sum(0),
            visible.to(torch.float32).sum(0),
            torch.where(visible, radii.to(torch.float32), 0.0).amax(0))


@torch.no_grad()
def apply_densification_increments(state: GaussianState, grad_inc, denom_inc,
                                   radii_max) -> GaussianState:
    """Add densification_increments' sums to the statistics, in place.
    The increments cover the store's leading rows (all of them, or the
    slab skip's prefix)."""
    n = grad_inc.shape[0]
    st = state.stats
    st.grad_accum[:n].add_(grad_inc)
    st.denom[:n].add_(denom_inc)
    mr = st.max_radii2d[:n]
    torch.maximum(mr, radii_max, out=mr)
    return state


def add_densification_stats_batched(state: GaussianState,
                                    mean2d_grads: torch.Tensor,
                                    radii: torch.Tensor) -> GaussianState:
    """Multi-view variant (legslam_tpu/models/gaussians.py:408):
    accumulate per-view ||dL/dmean2D.xy||2 with one denom increment per
    view visit, the reference's one-view-per-iteration accumulation
    (gaussian_model.cpp:834-847) under the batched step. mean2d_grads
    [B, P, 2] must already be un-scaled by the 1/B of the loss mean;
    radii [B, P]. In place."""
    return apply_densification_increments(
        state, *densification_increments(mean2d_grads, radii))


# ---------------------------------------------------------------------------
# Store surgery (gaussian_model.cpp:196-481, 567-832)
# ---------------------------------------------------------------------------

def _copy_params(p: GaussianParams) -> GaussianParams:
    return GaussianParams(**{k: v.clone() for k, v in p.as_dict().items()})


def copy_state(state: GaussianState) -> GaussianState:
    """A store that shares no tensor with `state` (the surgery's copy
    semantics; a snapshot that later in-place Adam steps leave alone)."""
    return GaussianState(
        params=_copy_params(state.params), valid=state.valid.clone(),
        exist_since=state.exist_since.clone(),
        adam_m=_copy_params(state.adam_m), adam_v=_copy_params(state.adam_v),
        adam_step=state.adam_step.clone(),
        stats=DensifyStats(**{n: getattr(state.stats, n).clone()
                              for n in STATS}),
        overflow_dropped=state.overflow_dropped.clone())


def state_tensors(state: GaussianState) -> list[torch.Tensor]:
    """Every tensor of the store, in a fixed order: the three parameter
    sets' groups, the statistics, valid, exist_since and the scalars."""
    out = []
    for group in (state.params, state.adam_m, state.adam_v):
        out += [getattr(group, name) for name in GROUPS]
    out += [getattr(state.stats, name) for name in STATS]
    return out + [state.valid, state.exist_since, state.adam_step,
                  state.overflow_dropped]


def map_rows(state: GaussianState, fn) -> GaussianState:
    """A store of fn(t) for every capacity-leading tensor t of `state`
    (the groups, moments, statistics, valid, exist_since); the scalars
    (step, overflow count) are copied."""
    def params(p):
        return GaussianParams(**{k: fn(v) for k, v in p.as_dict().items()})
    return GaussianState(
        params=params(state.params), valid=fn(state.valid),
        exist_since=fn(state.exist_since), adam_m=params(state.adam_m),
        adam_v=params(state.adam_v), adam_step=state.adam_step.clone(),
        stats=DensifyStats(**{n: fn(getattr(state.stats, n))
                              for n in STATS}),
        overflow_dropped=state.overflow_dropped.clone())


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Content-preserving migration to a larger capacity (the mapper's
    geometric capacity ladder; the reference reallocates its tensors as
    the map grows, gaussian_model.cpp densification_postfix): old rows are
    copied verbatim (params, moments, stats, flags), new slots take the
    empty() values (identity quats, zero moments, valid False)."""
    old = state.capacity
    if new_capacity < old:
        raise ValueError(f"cannot shrink capacity {old} to {new_capacity}")
    dst = empty(new_capacity, state.valid.device)
    for group in ("params", "adam_m", "adam_v"):
        for name in GROUPS:
            getattr(getattr(dst, group), name)[:old] = \
                getattr(getattr(state, group), name)
    for name in STATS:
        getattr(dst.stats, name)[:old] = getattr(state.stats, name)
    dst.valid[:old] = state.valid
    dst.exist_since[:old] = state.exist_since
    dst.adam_step = state.adam_step.clone()
    dst.overflow_dropped = state.overflow_dropped.clone()
    return dst


class ScatterPlan(NamedTuple):
    """Free-slot allocation of n source rows: the target slot of each
    source row (capacity = dropped) and the count dropped."""
    slots: torch.Tensor      # [n] int32
    n_dropped: torch.Tensor  # [] int32

    def rows(self, capacity: int):
        """(source rows, target slots) of the rows that got a slot, as
        int64 index tensors."""
        src = torch.nonzero(self.slots < capacity).squeeze(1)
        return src, self.slots[src].long()


def _allocate_slots(valid: torch.Tensor, want: torch.Tensor) -> ScatterPlan:
    """want: [n] bool, the source rows that need a slot. Free slots are
    handed out lowest index first, in source order (a stable argsort of
    valid puts the free slots first); rows past the free count drop."""
    capacity = valid.shape[0]
    order = torch.argsort(valid.to(torch.uint8), stable=True)
    n_free = capacity - valid.sum(dtype=torch.int32)
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    ok = want & (rank < n_free)
    slots = torch.where(ok, order[torch.clamp(rank, 0, capacity - 1).long()],
                        capacity)
    return ScatterPlan(slots=slots.to(torch.int32),
                       n_dropped=(want & ~ok).sum(dtype=torch.int32))


def _place_new_rows(st: GaussianState, src, dst, new: GaussianParams,
                    exist: torch.Tensor) -> None:
    """In place on st (a copy): the params of source rows `src` of `new`
    into slots `dst`, which become valid with zero moments and stats and
    the creation iterations exist[src]."""
    for name in GROUPS:
        getattr(st.params, name).index_copy_(
            0, dst, getattr(new, name).index_select(0, src))
        getattr(st.adam_m, name).index_fill_(0, dst, 0.0)
        getattr(st.adam_v, name).index_fill_(0, dst, 0.0)
    st.valid.index_fill_(0, dst, True)
    st.exist_since.index_copy_(0, dst, exist.index_select(0, src))


def increase_pcd(state: GaussianState, points, colors, iteration,
                 point_valid: torch.Tensor | None = None,
                 lang_feat: torch.Tensor | None = None,
                 max_log_scale: torch.Tensor | None = None) -> GaussianState:
    """Append new points into free slots (gaussian_model.cpp:196-385). New
    slots get zero Adam moments and zero densify stats; the shared step
    count is kept (densificationPostfix, gaussian_model.cpp:655-727).
    Points that find no free slot count in overflow_dropped.
    `max_log_scale` [n] caps each new point's knn log-scale init
    (MapperParams.ingest_scale_clamp_px; +inf = no cap)."""
    dev = state.valid.device
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    n = points.shape[0]
    if point_valid is None:
        point_valid = torch.ones(n, dtype=torch.bool, device=dev)
    plan = _allocate_slots(state.valid, point_valid)
    new = _new_point_params(points, colors, lang_feat, point_valid)
    if max_log_scale is not None:
        new.scaling = torch.minimum(new.scaling, max_log_scale[:, None])
    out = copy_state(state)
    src, dst = plan.rows(state.capacity)
    _place_new_rows(out, src, dst, new, torch.full(
        (n,), int(iteration), dtype=torch.int32, device=dev))
    for name in STATS:
        getattr(out.stats, name).index_fill_(0, dst, 0.0)
    out.overflow_dropped += plan.n_dropped
    return out


def densify_and_prune(state: GaussianState,
                      generator: torch.Generator | None,
                      grad_threshold: float, min_opacity: float,
                      extent: float, max_screen_size: float | None,
                      percent_dense: float,
                      noise: tuple | None = None) -> GaussianState:
    """Clone small / split large high-gradient gaussians, then prune.

    Reference flow (gaussian_model.cpp:729-832): grads = accum / denom;
    clone copies params verbatim when max(scale) <= percent_dense *
    extent; split draws 2 samples ~ N(0, scale), rotated and offset, with
    the new scale log(scale / (0.8 * 2)), and prunes the originals; prune
    drops opacity < min_opacity and, when max_screen_size is set, radii2D
    > max_screen_size or scale > 0.1 * extent. Stats reset after.

    The split noise is drawn from `generator` ([C, 3] standard normals,
    one array per child), or given as `noise`, two such arrays (the tests
    feed JAX's draws)."""
    p = state.params
    C = state.capacity
    dev = state.valid.device
    grads = torch.nan_to_num(
        state.stats.grad_accum / torch.clamp_min(state.stats.denom, 1e-12),
        nan=0.0)
    scales = torch.exp(p.scaling)
    max_scale = scales.max(dim=-1).values
    hot = state.valid & (grads >= grad_threshold)
    clone_m = hot & (max_scale <= percent_dense * extent)
    split_m = hot & (max_scale > percent_dense * extent)
    if noise is None:
        noise = [torch.randn(C, 3, generator=generator, device=dev)
                 for _ in range(2)]
    out = copy_state(state)
    max_radii = out.stats.max_radii2d

    # clones: verbatim copies into free slots
    plan_c = _allocate_slots(state.valid, clone_m)
    src, dst = plan_c.rows(C)
    _place_new_rows(out, src, dst, p, state.exist_since)
    # fresh slots must not inherit the previous occupant's radius stats
    max_radii.index_fill_(0, dst, 0.0)
    n_dropped = plan_c.n_dropped

    # splits: two perturbed children each, originals pruned
    rot = quat_to_rotmat(normalize_quat(p.rotation))    # [C, 3, 3]
    child_scaling = torch.log(scales / (0.8 * 2))
    for eps in noise:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        child = GaussianParams(
            xyz=p.xyz + torch.einsum("cij,cj->ci", rot, eps * scales),
            f_dc=p.f_dc, f_rest=p.f_rest, lang_feat=p.lang_feat,
            opacity=p.opacity, scaling=child_scaling, rotation=p.rotation)
        plan_s = _allocate_slots(out.valid, split_m)
        src, dst = plan_s.rows(C)
        _place_new_rows(out, src, dst, child, state.exist_since)
        max_radii.index_fill_(0, dst, 0.0)
        n_dropped = n_dropped + plan_s.n_dropped
    valid = out.valid & ~split_m

    # prune, over the updated store (new slots have zero radii stats)
    prune_m = torch.sigmoid(out.params.opacity[:, 0]) < min_opacity
    if max_screen_size is not None:
        big_ws = torch.exp(out.params.scaling).max(dim=-1).values > \
            0.1 * extent
        prune_m = prune_m | (max_radii > max_screen_size) | big_ws
    valid = valid & ~prune_m
    out.valid = valid
    # pruned slots zero their moments (gaussian_model.cpp prune surgery)
    for group in (out.adam_m, out.adam_v):
        for name in GROUPS:
            q = getattr(group, name)
            setattr(group, name, torch.where(
                valid.view((-1,) + (1,) * (q.ndim - 1)), q, 0.0))
    out.stats = DensifyStats(
        grad_accum=torch.zeros(C, device=dev),
        denom=torch.zeros(C, device=dev),
        max_radii2d=torch.where(valid, max_radii, 0.0))
    out.overflow_dropped += n_dropped
    return out


def reset_opacity(state: GaussianState) -> GaussianState:
    """opacity <- inverse_sigmoid(min(sigmoid(opacity), 0.01)), the opacity
    group's moments zeroed (gaussian_model.cpp:567-575 +
    replaceTensorToOptimizer)."""
    out = copy_state(state)
    act = torch.sigmoid(state.params.opacity)
    out.params.opacity = inverse_sigmoid(torch.clamp_max(act, 0.01))
    out.adam_m.opacity.zero_()
    out.adam_v.opacity.zero_()
    return out


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] wxyz. Branch-free Shoemake (matches
    cuda_rasterizer/operate_points.h:120-155 up to sign conventions;
    quaternions are sign-ambiguous and normalized on use)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return normalize_quat(torch.stack([qw, qx, qy, qz], -1))


def apply_scaled_transformation(state: GaussianState, scale: float,
                                R: torch.Tensor, t: torch.Tensor
                                ) -> GaussianState:
    """Whole-map similarity update: xyz <- R @ (s * xyz) + t, log-scale +=
    log(s), rotation <- R * rot; the xyz and scaling moments reset
    (gaussian_model.cpp:387-420 applyScaledTransformation; the reference
    multiplies the log-scales by s, a quirk it replaces in the optimizer
    at once; the geometrically right += log(s) is kept, as in
    legslam_tpu)."""
    out = copy_state(state)
    p = state.params
    out.params.xyz = (scale * p.xyz) @ R.T + t
    out.params.scaling = p.scaling + float(np.log(np.float32(scale)))
    out.params.rotation = rotmat_to_quat(
        R[None] @ quat_to_rotmat(normalize_quat(p.rotation)))
    for group in (out.adam_m, out.adam_v):
        group.xyz.zero_()
        group.scaling.zero_()
    return out


def mark_visible(xyz: torch.Tensor, world_view: torch.Tensor) -> torch.Tensor:
    """Frustum near-plane visibility (markVisible / in_frustum,
    rasterizer_impl.cu:211-228 + auxiliary.h:154)."""
    z = xyz @ world_view[2, :3] + world_view[2, 3]
    return z > NEAR_CLIP


def transform_visible_points(state: GaussianState,
                             not_transformed: torch.Tensor,
                             diff_R: torch.Tensor, diff_t: torch.Tensor,
                             kf_world_view: torch.Tensor,
                             kf_creation_iter: int,
                             stable_num_iter_existence: int, scale: float):
    """Loop-closure surgery on the points visible from a corrected keyframe
    (gaussian_model.cpp:422-481 + operate_points.cu:93-140): points that
    are (a) not yet transformed this op, (b) unstable (created within
    stable_num_iter_existence of the keyframe) and (c) in its frustum get
    p <- diff_R @ (s * p) + diff_t and composed rotations, their log-scales
    shift by log(s), and their xyz / rotation moments reset. Returns
    (state, updated not_transformed mask, count)."""
    p = state.params
    unstable = torch.abs(state.exist_since - kf_creation_iter) < \
        stable_num_iter_existence
    m = not_transformed & unstable & mark_visible(p.xyz, kf_world_view) & \
        state.valid
    mc = m[:, None]
    out = copy_state(state)
    xyz_new = (scale * p.xyz) @ diff_R.T + diff_t
    rot_new = rotmat_to_quat(
        diff_R[None] @ quat_to_rotmat(normalize_quat(p.rotation)))
    out.params.xyz = torch.where(mc, xyz_new, p.xyz)
    out.params.rotation = torch.where(mc, rot_new, p.rotation)
    # a Sim(3)-rescaled region rescales its gaussian extents too (no-op at
    # the reference's rigid scale 1)
    out.params.scaling = torch.where(
        mc, p.scaling + float(np.log(np.float32(scale))), p.scaling)
    for group in (out.adam_m, out.adam_v):
        group.xyz = torch.where(mc, 0.0, group.xyz)
        group.rotation = torch.where(mc, 0.0, group.rotation)
    return out, not_transformed & ~m, m.sum(dtype=torch.int32)


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
