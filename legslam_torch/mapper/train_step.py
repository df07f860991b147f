"""The mapping-training step.

Counterpart of legslam_tpu/mapper/train_step.py, the hot path of
GaussianMapper::trainForOneIteration (src/gaussian_mapper.cpp:624-798):
render (RGB+LF+depth), masked loss (1-λ)L1 + λ(1-SSIM) + mean-cos(LF) +
L1(depth), backward, Adam step and densification statistics. The
reference's screenspace_points gradient (gaussian_renderer.cpp:41-48) is
the gradient of an explicit zero `mean2d_offset`, scaled by the NDC
convention 0.5*W/H (backward.cu ddelx_dx/ddely_dy) before the stats
update.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.models import gaussians as G
from legslam_torch.ops import losses
from legslam_torch.ops.rasterize import render_arrays


class StepAux(NamedTuple):
    loss: torch.Tensor
    color: torch.Tensor
    depth: torch.Tensor
    radii: torch.Tensor
    psnr: torch.Tensor
    num_rendered: torch.Tensor | int = 0
    overflow_pairs: torch.Tensor | int = 0
    # per-tile termination watermark ("cuda" backend, emit_kfin steps);
    # feeds ops.binning.trim_binning for the cached-binning reuse steps
    kfin: torch.Tensor | None = None
    # [4] f32 (loss, overflow_pairs, num_rendered, num_valid), so a
    # periodic host sync is one copy
    sync3: torch.Tensor | None = None


def make_lrs(opt: OptimizationParams, spatial_lr_scale,
             position_lr_step) -> dict[str, Any]:
    """Per-group learning rates (gaussian_model.cpp:488-511: f_rest =
    feature_lr/20; the position LR is log-lerp scheduled by
    `position_lr_step` and scaled by the scene extent,
    gaussian_mapper.cpp:671-684)."""
    xyz_lr = G.expon_lr(
        position_lr_step,
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)
    return dict(
        xyz=xyz_lr, f_dc=opt.feature_lr, f_rest=opt.feature_lr / 20.0,
        lang_feat=opt.lang_feature_lr, opacity=opt.opacity_lr,
        scaling=opt.scaling_lr, rotation=opt.rotation_lr)


def train_step(state: G.GaussianState,
               world_view: torch.Tensor, full_proj: torch.Tensor,
               cam_center: torch.Tensor, tan_fovx, tan_fovy,
               gt_color: torch.Tensor, gt_lang_feat: torch.Tensor | None,
               gt_depth: torch.Tensor, mask: torch.Tensor,
               bg: torch.Tensor, position_lr_step, spatial_lr_scale,
               *, width: int, height: int, active_sh_degree: int,
               opt: OptimizationParams, cfg: RasterizeConfig,
               include_lang_feat: bool = True, max_per_tile: int = 2048,
               binning=None, emit_kfin: bool = False, gather_group=None,
               watermark_hint: int | None = None):
    """One optimization iteration on the state's device. Returns
    (state, StepAux); the state's tensors are updated in place.

    `binning` (optional): a cached (Binning, overflow) pair from
    ops.rasterize.compute_binning, for views whose geometry has not moved
    materially since the cache was built.

    `gather_group` (optional): the state is this rank's shard of a
    capacity-sharded store (parallel/capacity.py) over that process
    group. Inside the loss the parameter rows are all-gathered into the
    full working set; every rank renders the whole view, so each keeps
    its own rows of its gradient, and Adam and the statistics run on the
    local rows.

    cfg.p_slabs: the prologue, Adam and the statistics run on the
    whole-slab prefix covering the live watermark (ops/slabs.py).
    `watermark_hint` is that watermark if the caller knows it on the host
    (the mapper does, from its allocation bookkeeping); else it is read
    once here.
    """
    from legslam_torch.ops.slabs import watermark
    from legslam_torch.parallel import capacity

    if gt_lang_feat is not None and \
            tuple(gt_lang_feat.shape[:2]) != (height, width):
        gt_lang_feat = upsample_lf(gt_lang_feat, height, width)

    leaves = {name: t.detach().requires_grad_(True)
              for name, t in state.params.as_dict().items()}
    offset0 = torch.zeros(state.capacity, 2, device=state.valid.device,
                          requires_grad=True)

    def full(t):
        return capacity.gather(t, gather_group, partial=False)
    valid = full(state.valid)
    n_slabs = cfg.p_slabs if gather_group is None else 0
    if cfg.p_slabs and watermark_hint is None and \
            valid.shape[0] % cfg.p_slabs == 0:
        watermark_hint = int(watermark(valid))
    p = {name: full(t) for name, t in leaves.items()}
    sh = torch.cat([p["f_dc"], p["f_rest"]], dim=1)
    out = render_arrays(
        p["xyz"], sh, p["lang_feat"], torch.sigmoid(p["opacity"][:, 0]),
        torch.exp(p["scaling"]), p["rotation"], valid, world_view,
        full_proj, cam_center, tan_fovx, tan_fovy, width, height, bg,
        active_sh_degree, cfg, include_lang_feat=include_lang_feat,
        mean2d_offset=full(offset0), max_per_tile=max_per_tile,
        binning=binning, emit_kfin=emit_kfin, watermark_hint=watermark_hint)
    loss = losses.mapping_loss(
        out.color, gt_color, out.lang_feat, gt_lang_feat, out.depth,
        gt_depth, mask, opt.lambda_dssim)
    # without language features the lang_feat leaf is unused: zero grad
    grads = torch.autograd.grad(loss, [*leaves.values(), offset0],
                                allow_unused=True)

    # zero grads of invalid slots so their Adam moments only decay
    def masked(g, leaf):
        if g is None:
            return torch.zeros_like(leaf)
        return torch.where(state.valid.view((-1,) + (1,) * (g.ndim - 1)),
                           g, 0.0)
    g_params = G.GaussianParams(*(masked(g, leaf) for g, leaf in
                                  zip(grads[:-1], leaves.values())))

    # densification stats in the reference's NDC convention
    g2d = grads[-1]
    G.add_densification_stats(
        state, torch.stack([g2d[:, 0] * (0.5 * width),
                            g2d[:, 1] * (0.5 * height)], dim=1),
        capacity.local_rows(out.radii, gather_group), n_slabs=n_slabs,
        watermark_hint=watermark_hint)
    G.adam_update(state, g_params,
                  make_lrs(opt, spatial_lr_scale, position_lr_step),
                  n_slabs=n_slabs, watermark_hint=watermark_hint)

    loss = loss.detach()
    color, depth = out.color.detach(), out.depth.detach()
    m = mask if mask.ndim == 2 else mask[..., 0]
    psnr = losses.psnr(color * m[..., None], gt_color * m[..., None])
    sync3 = torch.stack([loss.float(),
                         torch.as_tensor(out.overflow_pairs).float(),
                         torch.as_tensor(out.num_rendered).float(),
                         valid.sum(dtype=torch.int32).float()])
    return state, StepAux(loss=loss, color=color, depth=depth,
                          radii=out.radii, psnr=psnr,
                          num_rendered=out.num_rendered,
                          overflow_pairs=out.overflow_pairs, kfin=out.kfin,
                          sync3=sync3)


def upsample_lf(lf_small: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
    """Bilinear resize of the 37x37x64 language-feature image to render
    resolution (gaussian_mapper.cpp:707-708), matching the JAX package's
    jax.image.resize(method="linear"): half-pixel bilinear, antialiased
    on an axis it shrinks. [h, w, C] -> [height, width, C]."""
    x = lf_small.permute(2, 0, 1)[None]
    up = F.interpolate(x, size=(height, width), mode="bilinear",
                       align_corners=False, antialias=True)
    return up[0].permute(1, 2, 0)
