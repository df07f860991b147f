"""Capacity-axis (FSDP-style) sharding of the gaussian store.

Counterpart of legslam_tpu/parallel/capacity.py. parallel/sharded.py
splits the views and parallel/spatial.py the pixels, but both keep a whole
store on every rank. Here the persistent store (the 7 parameter groups,
their Adam moments, the densify statistics, valid and exist_since) is
split over a process group of W ranks: each owns capacity / W consecutive
rows (shard_state). A mapping step follows the FSDP recipe:

  gather:  inside the loss, GatherRows all-gathers the parameter rows into
           the transient full working set the renderer needs;
  compute: the render and the loss;
  scatter: GatherRows' backward returns the gradients to the owner rows,
           and Adam and the densify statistics run on the local rows only.

The backward depends on how the ranks split the loss. When each rank's
loss is a part of the total (the strips of spatial_train_step split over
the same group), the owner's gradient is the sum over the ranks: a
reduce-scatter. When each rank computes the whole loss (the single-view
train_step with the store sharded alone; the JAX package's store-only 1D
mesh computes the render replicated), the owner's gradient is its own rows
of its own gradient.

Persistent memory per rank falls to ~1/W. The store's episodic surgery
(ingest, densify, prune, resets, loop-closure transforms) runs on the
whole store: gather_state assembles it on every rank and shard_state cuts
it again. The reference has no equivalent; it is strictly single-GPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from legslam_torch.models import gaussians as G
from legslam_torch.parallel.sharded import group_rank, group_size


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    W = group_size(group)
    src = x.contiguous()
    if src.dtype == torch.bool:
        return _all_gather_rows(src.to(torch.uint8), group).bool()
    out = src.new_empty((W * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out


class GatherRows(torch.autograd.Function):
    """apply(x, group, partial): the [W * n, ...] rows of every rank's
    [n, ...] x, in rank order. The backward reduce-scatters the gradient
    (sum over ranks) when `partial`, else keeps this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial, ctx.n = group, partial, x.shape[0]
        return _all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.partial:
            out = g.new_empty((ctx.n,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
        else:
            r = group_rank(ctx.group)
            out = g[r * ctx.n:(r + 1) * ctx.n]
        return out, None, None


def gather(x: torch.Tensor, group, partial: bool) -> torch.Tensor:
    """GatherRows over a group; the identity without one."""
    if group_size(group) == 1:
        return x
    return GatherRows.apply(x, group, partial)


def rows_of(x: torch.Tensor, n_ranks: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s block of n / n_ranks rows of an [n, ...] tensor."""
    n = x.shape[0] // n_ranks
    return x[rank * n:(rank + 1) * n]


def local_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of a full [capacity, ...] tensor."""
    return rows_of(x, group_size(group), group_rank(group))


def shard_state(state: G.GaussianState, group) -> G.GaussianState:
    """This rank's capacity / W rows of every capacity-leading tensor of
    the store (copies, so the full store can be freed); scalars are
    copied whole. Without a group, the store itself."""
    W = group_size(group)
    if W == 1:
        return state
    if state.capacity % W:
        raise ValueError(f"capacity {state.capacity} does not split over "
                         f"{W} ranks")
    return G.map_rows(state, lambda t: local_rows(t, group).clone())


def gather_state(local: G.GaussianState, group) -> G.GaussianState:
    """The whole store from every rank's shard (shard_state's inverse);
    without a group, the shard itself."""
    if group_size(group) == 1:
        return local
    return G.map_rows(local, lambda t: _all_gather_rows(t, group))


def shard_bytes_per_device(state: G.GaussianState) -> int:
    """Bytes of the store this rank holds (diagnostic; ~1/W of the whole
    store for a shard)."""
    return sum(t.numel() * t.element_size() for t in G.state_tensors(state))
