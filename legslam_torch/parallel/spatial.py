"""Tile-row strips of a single view: the mapping step rendered in strips.

Counterpart of legslam_tpu/parallel/spatial.py. The image splits into
n_strips horizontal strips of whole tile rows; each strip is rendered and
differentiated on its own against the whole store, and the parameter
gradients are the sums over the strips. Without a process group the
strips run in turn on the store's device; with a group of W ranks each
rank renders n_strips / W consecutive strips and the gradients are summed
with all_reduce (or, for a capacity-sharded store, reduce-scattered to the
owner rows: parallel/capacity.py).

How a strip render stays exact (ops/rasterize.py crop_y / crop_h): the
projection, the EWA clamp and the focal lengths are the full image's;
the screen-space means are shifted by the strip's row offset and binning
and compositing run at the strip's height. Per-tile pair lists and the
front-to-back order are the full render's, so a strip's rows equal the
full render's whenever the full render has span_overflow == 0.

Loss decomposition (ops/losses.mapping_loss over the full image, exactly):
  * L1(colour) + DSSIM need windows across strips: the strips' colours are
    reassembled into the full image (all-gathered across the ranks; every
    rank computes this term whole and back-propagates it into its own
    strips only) and the library terms run on it;
  * the LF cosine and the depth L1 are pixelwise means: each strip's rows
    (zero rows past the image: masked render, zero GT) give their share,
    rescaled so that the shares sum to H_pad / H times the mean over the
    padded rows, which is the full image's mean.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import (StepAux, activated,
                                             finish_step, leaves_of,
                                             screen_grads, view_increments)
from legslam_torch.models import gaussians as G
from legslam_torch.ops import losses
from legslam_torch.ops.rasterize import compute_binning, render_arrays
from legslam_torch.parallel import capacity
from legslam_torch.parallel.sharded import (ViewBatch, all_reduce_,
                                            batched_aux, batched_psnr,
                                            finish_batched_step, group_rank,
                                            group_size)


class SpatialLayout(NamedTuple):
    n_strips: int
    h_local: int       # strip height in pixels (a tile_h multiple)
    h_padded: int      # n_strips * h_local >= image height


def spatial_layout(height: int, tile_h: int, n_strips: int) -> SpatialLayout:
    """Split `height` pixel rows into n_strips whole-tile-row strips."""
    nty = -(-height // tile_h)
    rows_per = -(-nty // n_strips)
    return SpatialLayout(n_strips=n_strips, h_local=rows_per * tile_h,
                         h_padded=n_strips * rows_per * tile_h)


def pad_rows(arr: torch.Tensor, h_padded: int) -> torch.Tensor:
    """Zero-pad the leading (row) axis to h_padded."""
    pad = [0, 0] * (arr.ndim - 1) + [0, h_padded - arr.shape[0]]
    return F.pad(arr, pad)


def strip_offsets(layout: SpatialLayout) -> torch.Tensor:
    """[n_strips] pixel-row offset of each strip (float32, on the CPU)."""
    return torch.arange(layout.n_strips, dtype=torch.float32) * \
        layout.h_local


def local_strips(n_strips: int, group) -> range:
    """The strips this rank renders: n_strips / W consecutive ones."""
    W, r = group_size(group), group_rank(group)
    if n_strips % W:
        raise ValueError(f"{n_strips} strips do not split over {W} ranks")
    n = n_strips // W
    return range(r * n, (r + 1) * n)


def spatial_compute_binning(means3d, scales, quats, valid, world_view,
                            full_proj, tan_fovx, tan_fovy, crop_ys,
                            *, width: int, height: int, h_local: int,
                            cfg: RasterizeConfig, max_per_tile: int = 2048,
                            opacity=None, watermark_hint: int | None = None):
    """Per-strip binning cache: one ops.rasterize.compute_binning for each
    strip offset in crop_ys (the strips a rank renders), as a list.
    Activated scales / opacity, like compute_binning; the inputs are the
    whole store (binning needs the full depth order)."""
    return [compute_binning(
        means3d, scales, quats, valid, world_view, full_proj, tan_fovx,
        tan_fovy, width, height, cfg, max_per_tile=max_per_tile,
        opacity=opacity, crop_y=float(cy), crop_h=h_local,
        watermark_hint=watermark_hint) for cy in crop_ys]


def _strip_view_loss(params7: dict, valid, world_view, full_proj,
                     cam_center, tan_fovx, tan_fovy, gt_color_pad,
                     gt_lang_feat_pad, gt_depth_pad, mask_pad, bg, crop_ys,
                     mean2d_offset, binning, *, width: int, height: int,
                     h_local: int, active_sh_degree: int, lam: float,
                     cfg: RasterizeConfig, include_lang_feat: bool,
                     max_per_tile: int, strip_group=None,
                     watermark_hint: int | None = None):
    """One view's strip-decomposed render and mapping loss, over the
    strips of `crop_ys` (this rank's: local_strips) of a layout whose
    padded targets are [H_pad, ...]. Returns (loss, partial, color_pad,
    depth_pad, radii, num_rendered, overflow): `loss` is this rank's part
    of the view's loss (the colour terms whole, the pointwise ones of its
    strips), `partial` its pointwise part alone; color_pad / depth_pad are
    this rank's strips' rows (the colour all-gathered with its
    gradient kept to the own strips: every rank back-propagates the same
    colour term)."""
    args = activated(params7)
    outs = []
    for i, cy in enumerate(crop_ys):
        outs.append(render_arrays(
            *args, valid, world_view, full_proj, cam_center, tan_fovx,
            tan_fovy, width, height, bg, active_sh_degree, cfg,
            include_lang_feat=include_lang_feat,
            mean2d_offset=mean2d_offset, max_per_tile=max_per_tile,
            binning=None if binning is None else binning[i],
            crop_y=float(cy), crop_h=h_local,
            watermark_hint=watermark_hint))
    s0 = int(crop_ys[0]) if len(crop_ys) else 0
    rows = slice(s0, s0 + len(crop_ys) * h_local)
    color_loc = torch.cat([o.color for o in outs])
    depth_loc = torch.cat([o.depth for o in outs])
    color = capacity.gather(color_loc, strip_group, partial=False)
    m3 = mask_pad[..., None]
    pc_full = (color * m3)[:height]
    loss = (1.0 - lam) * losses.l1_loss(pc_full, gt_color_pad[:height]) \
        + lam * (1.0 - losses.ssim(pc_full, gt_color_pad[:height]))
    # this rank's rows' share of the pointwise means over the padded rows
    share = (rows.stop - rows.start) / float(height)
    mask_loc = mask_pad[rows]
    partial = share * losses.l1_loss(depth_loc * mask_loc,
                                     gt_depth_pad[rows])
    if include_lang_feat:
        lf_loc = torch.cat([o.lang_feat for o in outs])
        partial = share * losses._lf_cos_masked(
            lf_loc, gt_lang_feat_pad[rows], mask_loc, 1e-8) + partial
    radii = outs[0].radii if outs else None
    num_rendered = sum(o.num_rendered for o in outs)
    overflow = sum(o.overflow_pairs for o in outs)
    return (loss + partial, partial.detach(), color_loc.detach(),
            depth_loc.detach(), radii, num_rendered, overflow)


def _assemble_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank's strips, in strip order."""
    return capacity.gather(x, group, partial=False).detach() \
        if group_size(group) > 1 else x


def spatial_train_step(state: G.GaussianState,
                       world_view, full_proj, cam_center, tan_fovx,
                       tan_fovy, gt_color_pad, gt_lang_feat_pad,
                       gt_depth_pad, mask_pad, bg, position_lr_step,
                       spatial_lr_scale, crop_ys,
                       *, width: int, height: int, h_local: int,
                       active_sh_degree: int, opt: OptimizationParams,
                       cfg: RasterizeConfig, include_lang_feat: bool = True,
                       max_per_tile: int = 2048, binning=None, group=None,
                       shard_store: bool = False,
                       watermark_hint: int | None = None):
    """One single-view iteration rendered in strips, in place on the state.

    Semantics are mapper/train_step.train_step's on the same view (same
    loss, gradients, Adam update and densify statistics): the strips
    partition the pixels, so each parameter's gradient is the sum of the
    strips', and one shared mean2D offset sums into the single-view
    screen gradient. The targets come padded to h_padded = n_strips *
    h_local rows (pad_rows) with a zero mask on the pad rows; crop_ys are
    every strip's offsets (strip_offsets), of which this rank renders
    local_strips; `binning` is an optional list of cached per-strip
    binnings (spatial_compute_binning) of this rank's strips.

    With `group`, the strips split over its ranks. With `shard_store` the
    state is this rank's shard of a store capacity-sharded over the same
    group (parallel/capacity.py): the rows are all-gathered inside the
    loss and the gradients reduce-scattered to their owners.
    """
    H_pad = gt_color_pad.shape[0]
    n_strips = len(crop_ys)
    if H_pad != n_strips * h_local:
        raise ValueError(f"padded height {H_pad} is not {n_strips} strips "
                         f"of {h_local} rows")
    mine = local_strips(n_strips, group)
    cys = [crop_ys[i] for i in mine]
    gather_group = group if shard_store else None
    leaves = leaves_of(state)
    dev = state.valid.device
    offset0 = torch.zeros(state.capacity, 2, device=dev, requires_grad=True)

    def full(t):
        return capacity.gather(t, gather_group, partial=True)
    valid = capacity.gather(state.valid, gather_group, partial=True)
    p = {name: full(t) for name, t in leaves.items()}
    loss, partial, color_loc, depth_loc, radii, num_rendered, overflow = \
        _strip_view_loss(
            p, valid, world_view, full_proj, cam_center, tan_fovx, tan_fovy,
            gt_color_pad, gt_lang_feat_pad, gt_depth_pad, mask_pad, bg, cys,
            full(offset0), binning, width=width, height=height,
            h_local=h_local, active_sh_degree=active_sh_degree,
            lam=opt.lambda_dssim, cfg=cfg,
            include_lang_feat=include_lang_feat, max_per_tile=max_per_tile,
            strip_group=group, watermark_hint=watermark_hint)
    grads = list(torch.autograd.grad(loss, [*leaves.values(), offset0],
                                     allow_unused=True))
    if not shard_store:
        # the strips' gradients (a shard's were reduce-scattered already)
        all_reduce_(grads, group)
    # radii are the full preprocess's, the same for every strip
    n_slabs = cfg.p_slabs if gather_group is None else 0
    finish_step(state, grads[:-1], view_increments(
        state, grads[-1], capacity.local_rows(radii, gather_group), width,
        height, n_slabs, watermark_hint), opt, position_lr_step,
        spatial_lr_scale, n_slabs, watermark_hint)

    totals = torch.stack([partial, torch.as_tensor(
        num_rendered, dtype=torch.float32, device=dev), torch.as_tensor(
        overflow, dtype=torch.float32, device=dev)])
    all_reduce_([totals], group)
    loss = loss.detach() - partial + totals[0]
    color = _assemble_rows(color_loc, group)[:height]
    depth = _assemble_rows(depth_loc, group)[:height]
    mh = mask_pad[:height][..., None]
    psnr = losses.psnr(color * mh, gt_color_pad[:height] * mh)
    sync3 = torch.stack([loss, totals[2], totals[1],
                         valid.sum(dtype=torch.int32).float()])
    return state, StepAux(loss=loss, color=color, depth=depth, radii=radii,
                          psnr=psnr,
                          num_rendered=totals[1].to(torch.int32),
                          overflow_pairs=totals[2].to(torch.int32),
                          sync3=sync3)


def make_groups(n_views: int, n_strips: int):
    """The counterpart of make_mesh2d: the default group's first
    n_views * n_strips ranks as a views x strips grid (rank = v * n_strips
    + s), cut into two subgroups for this rank: its strip group (the
    ranks of its view row) and its view group (the ranks of its strip
    column). Every rank of the default group must call it; (None, None)
    for a rank outside the grid."""
    import torch.distributed as dist
    need = n_views * n_strips
    if not dist.is_initialized() or dist.get_world_size() < need:
        raise ValueError(f"make_groups({n_views}, {n_strips}): no process "
                         f"group of {need} ranks")
    rank = dist.get_rank()
    strip_group = view_group = None
    for v in range(n_views):
        g = dist.new_group([v * n_strips + s for s in range(n_strips)])
        if rank // n_strips == v and rank < need:
            strip_group = g
    for s in range(n_strips):
        g = dist.new_group([v * n_strips + s for v in range(n_views)])
        if rank % n_strips == s and rank < need:
            view_group = g
    return view_group, strip_group


def spatial_batched_train_step(state: G.GaussianState, batch: ViewBatch,
                               bg, position_lr_step, spatial_lr_scale,
                               crop_ys, *, width: int, height: int,
                               h_local: int, active_sh_degree: int,
                               opt: OptimizationParams,
                               cfg: RasterizeConfig,
                               include_lang_feat: bool = True,
                               max_per_tile: int = 2048, view_group=None,
                               strip_group=None):
    """Both axes at once: a batch of keyframes, each rendered in strips
    (parallel/sharded.batched_train_step with spatial_train_step's
    per-view render), in place on the state. `batch` holds this rank's
    views (its view group's share) with targets row-padded to n_strips *
    h_local (pad_rows); its strip group splits each view's strips.
    Semantics: the batched step's (per-view masked loss mean, per-view
    densify statistics)."""
    W_v = group_size(view_group)
    B_local = batch.gt_color.shape[0]
    B = W_v * B_local
    mine = local_strips(len(crop_ys), strip_group)
    cys = [crop_ys[i] for i in mine]
    leaves = leaves_of(state)
    dev = state.valid.device
    loss_sum = torch.zeros((), device=dev)
    sq_err = torch.zeros((), device=dev)
    per_view, radii = [], []
    overflow = torch.zeros((), device=dev)
    color0 = depth0 = None
    for v in range(B_local):
        off = torch.zeros(state.capacity, 2, device=dev, requires_grad=True)
        loss, partial, color_loc, depth_loc, r, _, ov = _strip_view_loss(
            leaves, state.valid, batch.world_view[v], batch.full_proj[v],
            batch.cam_center[v], float(batch.tan_fovx[v]),
            float(batch.tan_fovy[v]), batch.gt_color[v],
            batch.gt_lang_feat[v], batch.gt_depth[v], batch.mask[v], bg,
            cys, off, None, width=width, height=height, h_local=h_local,
            active_sh_degree=active_sh_degree, lam=opt.lambda_dssim,
            cfg=cfg, include_lang_feat=include_lang_feat,
            max_per_tile=max_per_tile, strip_group=strip_group)
        (loss / B).backward()
        part = torch.stack([partial, torch.as_tensor(
            ov, dtype=torch.float32, device=dev)])
        all_reduce_([part], strip_group)
        loss_sum += loss.detach() - partial + part[0]
        overflow += part[1]
        per_view.append(off.grad)
        radii.append(r)
        color = _assemble_rows(color_loc, strip_group)[:height]
        m = batch.mask[v][:height][..., None]
        sq_err += torch.sum((color * m - batch.gt_color[v][:height] * m)
                            ** 2)
        if v == 0:
            color0 = color
            depth0 = _assemble_rows(depth_loc, strip_group)[:height]
    radii = torch.stack(radii)
    # each view's screen gradient: summed over its strips, the loss
    # mean's 1/B undone
    g2d = torch.stack(per_view)
    all_reduce_([g2d], strip_group)
    g2d = screen_grads(g2d, width, height, views=B)
    all_reduce_([leaf.grad for leaf in leaves.values()], strip_group)
    finish_batched_step(state, leaves, g2d, radii, opt, position_lr_step,
                        spatial_lr_scale, view_group)
    totals = torch.stack([loss_sum, overflow])
    all_reduce_([totals], view_group)
    rmax = radii.amax(0)
    all_reduce_([rmax], view_group, torch.distributed.ReduceOp.MAX)
    psnr = batched_psnr(sq_err, B * height * width * 3, view_group)
    return state, batched_aux(state, totals, B, color0, depth0, rmax, psnr)
