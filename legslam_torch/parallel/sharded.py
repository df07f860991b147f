"""Multi-view mapping: one step over a batch of keyframes.

Counterpart of legslam_tpu/parallel/sharded.py. The reference maps one
keyframe per iteration (gaussian_mapper.cpp:624-798) on one GPU; the JAX
package batches n keyframes into one step on a device mesh, each device
rendering and differentiating its views against the replicated store,
with XLA's psum reducing the gradients. Here:

  * without a process group (or with one rank) the views run in turn on
    the store's device, each backward accumulating into the same
    gradients (this bounds the peak memory to one view's graph);
  * with a torch.distributed group of W > 1 ranks, each rank takes B / W
    of the views (shard_batch); the parameter gradients and the densify
    statistics' increments are summed with all_reduce before the one Adam
    update, which every rank then applies to its replica of the store
    (replicate_state makes the replicas equal).

Per-view semantics as in JAX: the loss is the mean of the views' masked
mapping losses; every view has its own zero mean2D offset, whose gradient,
rescaled by B (the loss mean's 1/B undone), gives that view's screen-space
gradient, so the densify statistics accumulate a mean of norms with one
visit count per view (gaussian_model.cpp:834-847).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import (StepAux, activated,
                                             finish_step, leaves_of,
                                             screen_grads)
from legslam_torch.models import gaussians as G
from legslam_torch.ops import losses
from legslam_torch.ops.rasterize import render_arrays


class ViewBatch(NamedTuple):
    """Stacked per-keyframe tensors, leading axis = the batch."""
    world_view: torch.Tensor    # [B, 4, 4]
    full_proj: torch.Tensor     # [B, 4, 4]
    cam_center: torch.Tensor    # [B, 3]
    tan_fovx: torch.Tensor      # [B] float64 (the views' own floats)
    tan_fovy: torch.Tensor      # [B] float64
    gt_color: torch.Tensor      # [B, H, W, 3]
    gt_lang_feat: torch.Tensor  # [B, H, W, LF]
    gt_depth: torch.Tensor      # [B, H, W]
    mask: torch.Tensor          # [B, H, W]


def group_size(group) -> int:
    """Ranks of `group`; 1 for None (the one-device path)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def make_group(n: int):
    """The counterpart of make_mesh: a process group of the default
    group's first n ranks, or None for n <= 1. Every rank of the default
    group must call it (torch.distributed.new_group's contract); a rank
    outside the group gets None and runs the one-device path."""
    if n <= 1:
        return None
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise ValueError(f"make_group({n}): no process group of {n} ranks")
    if n == dist.get_world_size():
        return dist.group.WORLD
    g = dist.new_group(list(range(n)))
    return g if dist.get_rank() < n else None


def all_reduce_(tensors, group, op=dist.ReduceOp.SUM) -> None:
    """In-place all_reduce of same-dtype tensors in one flat buffer. A
    None (the gradient of a group the loss does not reach, None on every
    rank alike) is left out."""
    tensors = [t for t in tensors if t is not None]
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def _broadcast_(t: torch.Tensor, group) -> None:
    src = dist.get_global_rank(group, 0)
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.broadcast(u, src=src, group=group)
        t.copy_(u.bool())
    else:
        dist.broadcast(t, src=src, group=group)


def replicate_state(state: G.GaussianState, group) -> G.GaussianState:
    """Make every rank's store its group's rank 0's, in place (the
    counterpart of placing the state replicated on the mesh)."""
    if group_size(group) > 1:
        for t in G.state_tensors(state):
            _broadcast_(t, group)
    return state


def shard_batch(batch: ViewBatch, group) -> ViewBatch:
    """This rank's B / W consecutive views of the batch."""
    W, r = group_size(group), group_rank(group)
    B = batch.gt_color.shape[0]
    if B % W:
        raise ValueError(f"{B} views do not split over {W} ranks")
    n = B // W
    return ViewBatch(*(x[r * n:(r + 1) * n] for x in batch))


def make_view_batch(views, gt_color, gt_lang_feat, gt_depth, mask
                    ) -> ViewBatch:
    """A ViewBatch of CameraViews and their stacked [B, ...] targets."""
    dev = gt_color.device
    return ViewBatch(
        world_view=torch.stack([v.world_view for v in views]),
        full_proj=torch.stack([v.full_proj for v in views]),
        cam_center=torch.stack([v.cam_center for v in views]),
        tan_fovx=torch.tensor([v.tan_fovx for v in views],
                              dtype=torch.float64),
        tan_fovy=torch.tensor([v.tan_fovy for v in views],
                              dtype=torch.float64),
        gt_color=gt_color, gt_lang_feat=gt_lang_feat.to(dev),
        gt_depth=gt_depth, mask=mask)


def _render_view(leaves, valid, batch: ViewBatch, v: int, offset, bg,
                 width, height, active_sh_degree, cfg, include_lang_feat,
                 max_per_tile):
    return render_arrays(
        *activated(leaves), valid, batch.world_view[v], batch.full_proj[v],
        batch.cam_center[v], float(batch.tan_fovx[v]),
        float(batch.tan_fovy[v]), width, height, bg, active_sh_degree, cfg,
        include_lang_feat=include_lang_feat, mean2d_offset=offset,
        max_per_tile=max_per_tile)


def finish_batched_step(state: G.GaussianState, leaves: dict,
                        per_view_grads: torch.Tensor, radii: torch.Tensor,
                        opt: OptimizationParams, position_lr_step,
                        spatial_lr_scale, group) -> None:
    """The batched steps' reductions, then the step's tail
    (train_step.finish_step), in place: the parameter gradients
    (accumulated in `leaves`) and the per-view densify increments summed
    over `group` in one buffer, the radii's maximum over it."""
    grads = [leaf.grad for leaf in leaves.values()]
    incs = list(G.densification_increments(per_view_grads, radii))
    all_reduce_(grads + incs[:2], group)
    all_reduce_(incs[2:], group, dist.ReduceOp.MAX)
    finish_step(state, grads, incs, opt, position_lr_step, spatial_lr_scale)


def batched_psnr(sq_err: torch.Tensor, n: int, group) -> torch.Tensor:
    """PSNR of the batch's masked colour from this rank's summed squared
    error over n elements (losses.psnr over every view's pixels)."""
    acc = torch.stack([sq_err.double(), torch.tensor(
        float(n), dtype=torch.float64, device=sq_err.device)])
    all_reduce_([acc], group)
    return (10.0 * torch.log10(acc[1] / acc[0])).float()


def batched_aux(state: G.GaussianState, totals: torch.Tensor, B: int,
                color, depth, radii, psnr) -> StepAux:
    """The batched steps' StepAux from the batch's summed (loss,
    overflow) `totals`: the loss is the views' mean, and sync3 carries no
    rendered-pair count."""
    loss = totals[0] / B
    sync3 = torch.stack([loss, totals[1], torch.zeros_like(loss),
                         state.valid.sum(dtype=torch.int32).float()])
    return StepAux(loss=loss, color=color, depth=depth, radii=radii,
                   psnr=psnr, overflow_pairs=totals[1].to(torch.int32),
                   sync3=sync3)


def batched_train_step(state: G.GaussianState, batch: ViewBatch,
                       bg: torch.Tensor, position_lr_step, spatial_lr_scale,
                       *, width: int, height: int, active_sh_degree: int,
                       opt: OptimizationParams, cfg: RasterizeConfig,
                       include_lang_feat: bool = True,
                       max_per_tile: int = 2048, group=None):
    """One step over a batch of keyframes, in place on the state; returns
    (state, StepAux) as legslam_tpu's batched_train_step. `batch` holds
    this rank's views (shard_batch) of a batch of B = W * B_local views;
    without a group, all of them. The aux's colour and depth are this
    rank's first view's; loss, psnr, radii and overflow cover the batch."""
    W = group_size(group)
    B_local = batch.gt_color.shape[0]
    B = W * B_local
    leaves = leaves_of(state)
    dev = state.valid.device
    loss_sum = torch.zeros((), device=dev)
    sq_err = torch.zeros((), device=dev)
    per_view, radii, overflow = [], [], torch.zeros((), dtype=torch.int32,
                                                    device=dev)
    color0 = depth0 = None
    for v in range(B_local):
        off = torch.zeros(state.capacity, 2, device=dev, requires_grad=True)
        out = _render_view(leaves, state.valid, batch, v, off, bg, width,
                           height, active_sh_degree, cfg, include_lang_feat,
                           max_per_tile)
        loss = losses.mapping_loss(
            out.color, batch.gt_color[v],
            out.lang_feat, batch.gt_lang_feat[v] if include_lang_feat
            else None, out.depth, batch.gt_depth[v], batch.mask[v],
            opt.lambda_dssim)
        (loss / B).backward()
        loss_sum += loss.detach()
        # the view's screen gradient: the loss mean's 1/B undone
        per_view.append(screen_grads(off.grad, width, height, views=B))
        radii.append(out.radii)
        overflow += out.overflow_pairs
        m = batch.mask[v][..., None]
        color = out.color.detach()
        sq_err += torch.sum((color * m - batch.gt_color[v] * m) ** 2)
        if v == 0:
            color0, depth0 = color, out.depth.detach()
    radii = torch.stack(radii)
    finish_batched_step(state, leaves, torch.stack(per_view), radii, opt,
                        position_lr_step, spatial_lr_scale, group)
    totals = torch.stack([loss_sum, overflow.float()])
    all_reduce_([totals], group)
    rmax = radii.amax(0)
    all_reduce_([rmax], group, dist.ReduceOp.MAX)
    psnr = batched_psnr(sq_err, B * height * width * 3, group)
    return state, batched_aux(state, totals, B, color0, depth0, rmax, psnr)
