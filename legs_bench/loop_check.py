"""How a loop cell's `correct` is decided: what the window produced,
compared with the plain reference (legs_bench/reference/) on the inputs
the benchmark made.

  - encoder: the LF image of a seeded sample of the window's frames,
    against the reference encoder on the same decoded frame
    (`lf_gap`: the largest |difference| over the reference's largest
    |value|);
  - keyframe ingest: every pyramid level of a seeded sample of the
    window's keyframes, colour and depth, against the reference's pyramid
    of the same frame (`ingest_mismatch`: elements that differ; exact);
  - binning: a seeded reservoir of the window's binnings (the mapper's
    cache fills): the program's pair list and the reference's own binning
    of the same store and view, each rendered by the reference
    (`binning_gap`: the largest |difference| of colour, features and
    depth over the reference's largest |value|);
  - mapping step: a seeded reservoir of the window's steps. From the
    program's own state before the step (the store, and the pair list the
    step was handed: the configuration's binning cache reuses a binning up
    to 3 times, trimmed at a termination watermark, so the reference
    follows it step by step) and the reference's own targets, LF and
    view, the reference renders, takes the loss and its gradient and makes
    the Adam step. `step_loss_gap` is the relative gap of the loss,
    `step_color_gap` the largest |difference| of the rendered colour,
    `step_grad_gap` and `step_change_gap` the gap between the program's
    and the reference's norm of each group's gradient (the program's as
    its Adam update got it) and of its change, over the larger of the
    reference's norm of that group and of the median group, worst group.
    Groups whose reference gradient is under a thousandth of the median
    group's are left out of those two (f_rest before the SH degree rises:
    zero on both sides);
  - store growth (legs_bench/reference/growth.py): every keyframe
    operation of the window adds the rows the reference's ingest rule
    says, map points and depth-cache flushes, from the keyframe's
    keypoints, the benchmark's own frame and pose, and the cache as it
    stood when the window opened (`growth_count_gap`: rows added that
    differ, summed, and pending batches at the start whose size differs
    from the reference's); the rows of a seeded operation that flushed
    the cache, and of a seeded one of all, lie where the reference puts
    them (`growth_row_gap`: the largest |difference| of a position in
    metres or of a colour; infinite when the counts differ or the window
    added nothing);
  - densification (`densify_gap`): the window ran frames x iterations a
    frame iterations and densified after exactly those the schedule
    names (each missing, extra or iteration amiss counts one), and a
    seeded densification left the valid count that the reference's rule
    gives from the program's store before it (the difference added).
"""
from __future__ import annotations

import random

import numpy as np
import torch

from legs_bench import scene
from legs_bench.reference import encoder as ref_encoder
from legs_bench.reference import growth as ref_growth
from legs_bench.reference import mapping as ref

GROUPS = ref.GROUPS


def store_copy(state) -> dict:
    """Copies of a store's parameters, Adam moments and step, and valid
    rows (the program's own state, read, never written)."""
    def copy(p):
        return {k: getattr(p, k).detach().clone() for k in GROUPS}
    return dict(params=copy(state.params), m=copy(state.adam_m),
                v=copy(state.adam_v), step=int(state.adam_step),
                valid=state.valid.detach().clone())


def pair_list(binning) -> tuple:
    """The pair list of a flat binning: (gaussian ids in (tile, depth)
    order, tile starts, tile counts)."""
    return (binning.pair_gid, binning.tile_start, binning.tile_count)


def keyframe_copies(mapper, fids: list, k: int, seed: int) -> list:
    """The pyramids of a seeded sample of the window's keyframes, as the
    program's mapper holds them."""
    rng = random.Random(seed + 1)
    fids = [f for f in fids if f in mapper.keyframes]
    pick = rng.sample(fids, min(k, len(fids)))
    return [dict(fid=f, color=list(mapper.keyframes[f].gt_color),
                 depth=list(mapper.keyframes[f].gt_depth)) for f in pick]


def sample_outputs(outputs: list, k: int, seed: int) -> list:
    rng = random.Random(seed + 2)
    return rng.sample(outputs, min(k, len(outputs)))


def _ref_lf(enc_w, color: np.ndarray, cfg: dict, dev) -> torch.Tensor:
    params, pca = enc_w
    x = torch.as_tensor(color, device=dev)[None]
    return ref_encoder.encode(params, pca, x, cfg,
                              getattr(torch, cfg["dtype"]))[0]


def lf_gap(outputs: list, seq, enc_w, cfg: dict, dev) -> float:
    worst = 0.0
    for index, lf in outputs:
        color, _ = scene.decode(seq, index % len(seq))
        want = _ref_lf(enc_w, color, cfg, dev)
        gap = (lf.float() - want).abs().max() / want.abs().max()
        worst = max(worst, float(gap))
    return worst


def ingest_mismatch(keyframes: list, seq, mp) -> float:
    """Elements of the sampled keyframes' pyramids that differ from the
    reference's; infinite when the window made no keyframe to compare."""
    if not keyframes:
        return float("inf")
    bad = 0
    levels = mp.num_gaus_pyramid_sub_levels if mp.do_gaus_pyramid_training \
        else 0
    for kf in keyframes:
        color, depth = scene.decode(seq, kf["fid"] % len(seq))
        want = ref.pyramid(color, depth, levels)
        if len(want) != len(kf["color"]):
            bad += 1
            continue
        for (wc, wd), pc, pd in zip(want, kf["color"], kf["depth"]):
            pc, pd = pc.cpu().numpy(), pd.cpu().numpy()
            if pc.shape != wc.shape or pd.shape != wd.shape:
                bad += wc.size + wd.size
                continue
            bad += int((pc != wc).sum()) + int((pd != wd).sum())
    return bad


def _frame_of(world_view: np.ndarray, seq) -> int:
    """The loop frame whose pose gives this world-to-view matrix."""
    w2c = np.linalg.inv(seq.c2w)
    err = np.abs(w2c[:, :3, :] - world_view[None, :3, :]).max(axis=(1, 2))
    i = int(np.argmin(err))
    if err[i] > 1e-4:
        raise ValueError(f"no frame of the loop has this view (error "
                         f"{err[i]:.3g})")
    return i


def extent(seq, kf_stride: int, n_kfs: int) -> float:
    """The scene radius of the mapper's initial keyframes (nerf++ norm:
    1.1 times the largest distance of a camera centre from their mean),
    the centres taken from the float32 world-to-camera poses the frontend
    hands on."""
    centers = []
    for j in range(n_kfs):
        w2c = np.linalg.inv(seq.c2w[(j * kf_stride) % len(seq)]).astype(
            np.float32)
        centers.append(-(w2c[:3, :3].T @ w2c[:3, 3]))
    centers = np.asarray(centers, np.float32)
    c = centers.mean(axis=0)
    return max(float(np.linalg.norm(centers - c, axis=-1).max() * 1.1),
               1e-6)


def reference_step(rec: dict, seq, intr: dict, opt, mp, config: dict,
                   enc_w, dev, feat_dtype=torch.bfloat16) -> dict:
    """The reference's step from the program's pre-step store: loss,
    colour, gradients and the parameters after Adam."""
    i = _frame_of(rec["world_view"], seq)
    color, depth = scene.decode(seq, i)
    levels = mp.num_gaus_pyramid_sub_levels if mp.do_gaus_pyramid_training \
        else 0
    pyr = ref.pyramid(color, depth, levels)
    shapes = [c.shape[:2] for c, _ in pyr]
    lvl = shapes.index((rec["height"], rec["width"]))
    c2w = seq.c2w[i]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    fovx = ref.focal2fov(intr["fx"], intr["width"])
    fovy = ref.focal2fov(intr["fy"], intr["height"])
    v = ref.view(w2c[:3, :3], w2c[:3, 3], rec["width"], rec["height"],
                 fovx, fovy, dev)
    gt_c, gt_d = pyr[lvl]
    lf_grid = _ref_lf(enc_w, color, config["encoder"], dev)
    gt = dict(color=torch.as_tensor(gt_c, device=dev),
              depth=torch.as_tensor(gt_d, device=dev),
              mask=torch.ones(rec["height"], rec["width"], device=dev),
              lf=ref.upsample_lf(lf_grid, rec["height"], rec["width"]))
    pre = rec["pre"]
    app = config["app"]
    rcfg = dict(tile_w=app["tile_w"], tile_h=app["tile_h"],
                chunk=app["chunk"], tile_batch=app["ref_tile_batch"])
    pairs = None if rec["pairs"] is None else ref.given_pairs(
        *rec["pairs"], rec["max_pairs"])
    loss, col, grads = ref.render_and_grad(
        pre["params"], pre["valid"], v, rec["sh_degree"], gt, rcfg,
        feat_dtype, opt.lambda_dssim, pairs=pairs)
    ext = extent(seq, app["kf_stride"], mp.min_num_initial_map_kfs)
    o = dict(position_lr_init=opt.position_lr_init,
             position_lr_final=opt.position_lr_final,
             position_lr_delay_mult=opt.position_lr_delay_mult,
             position_lr_max_steps=opt.position_lr_max_steps,
             feature_lr=opt.feature_lr, lang_feature_lr=opt.lang_feature_lr,
             opacity_lr=opt.opacity_lr, scaling_lr=opt.scaling_lr,
             rotation_lr=opt.rotation_lr)
    lrs = ref.learning_rates(o, ext, rec["lr_step"])
    post = ref.adam(pre["params"], pre["m"], pre["v"], pre["step"], grads,
                    lrs)
    return dict(loss=loss, color=col, grads=grads, post=post)


def _view_of(rec: dict, seq, intr: dict, dev) -> dict:
    i = _frame_of(rec["world_view"], seq)
    w2c = np.linalg.inv(seq.c2w[i]).astype(np.float32)
    return ref.view(w2c[:3, :3], w2c[:3, 3], rec["width"], rec["height"],
                    ref.focal2fov(intr["fx"], intr["width"]),
                    ref.focal2fov(intr["fy"], intr["height"]), dev)


def binning_gap(rec: dict, seq, intr: dict, config: dict, dev) -> float:
    """The program's pair list against the reference's own binning of the
    same store and view, judged by what each renders: the largest
    |difference| of the colour, the language features and the depth, each
    over the largest |value| of the reference's."""
    app = config["app"]
    rcfg = dict(tile_w=app["tile_w"], tile_h=app["tile_h"],
                chunk=app["chunk"], tile_batch=app["ref_tile_batch"])
    v = _view_of(rec, seq, intr, dev)
    st = rec["store"]
    args = (st["params"], st["valid"], v, rec["sh_degree"], rcfg,
            torch.bfloat16)
    got = ref.render(*args, pairs=ref.given_pairs(*rec["pairs"],
                                                  rec["max_pairs"]))
    want = ref.render(*args)
    gap = 0.0
    for sl in (slice(0, 3), slice(3, -1), slice(-1, None)):
        scale = float(want[..., sl].abs().max().clamp_min(1e-12))
        gap = max(gap, float((got[..., sl] - want[..., sl]).abs().max())
                  / scale)
    return gap


def _norm(t, valid) -> float:
    return float(torch.linalg.vector_norm(t[valid].double()))


def step_numbers(rec: dict, want: dict) -> dict:
    """The four step numbers of one recorded step against the
    reference's."""
    pre, post, valid = rec["pre"], rec["post"], rec["pre"]["valid"]
    g_ref = {k: _norm(want["grads"][k], valid) for k in GROUPS}
    med = float(np.median(list(g_ref.values())))
    counted = [k for k in GROUPS if g_ref[k] >= 1e-3 * med]
    grad_gap = change_gap = 0.0
    for k in counted:
        gp = _norm(rec["grads"][k], valid)
        grad_gap = max(grad_gap,
                       abs(gp - g_ref[k]) / max(g_ref[k], med, 1e-30))
    d_ref = {k: _norm(want["post"][k] - pre["params"][k], valid)
             for k in counted}
    d_med = float(np.median(list(d_ref.values())))
    for k in counted:
        dp = _norm(post["params"][k] - pre["params"][k], valid)
        change_gap = max(change_gap,
                         abs(dp - d_ref[k]) / max(d_ref[k], d_med, 1e-30))
    loss_ref = float(want["loss"])
    return dict(
        step_loss_gap=abs(float(rec["loss"]) - loss_ref) / abs(loss_ref),
        step_color_gap=float((rec["color"] - want["color"]).abs().max()),
        step_grad_gap=grad_gap, step_change_gap=change_gap)


def _keyframe_points(g: dict, seq, intr: dict, mp, dtype=np.float64):
    memo = {}

    def points(fid):
        if fid not in memo:
            i = fid % len(seq)
            color, depth = scene.decode(seq, i)
            memo[fid] = ref_growth.keypoint_points(
                g["keypoints"][fid], color, depth, seq.c2w[i], intr,
                mp.rgbd_min_depth, mp.rgbd_max_depth, dtype)
        return memo[fid]
    return points


def growth_numbers(kept: dict, seq, intr: dict, opt, mp, config: dict,
                   extent_m: float, dtype=np.float64) -> dict:
    """`growth_count_gap`, `growth_row_gap` and `densify_gap` of the
    window (module docstring)."""
    g = kept["growth"]
    points = _keyframe_points(g, seq, intr, mp, dtype)
    start = g["start"]
    # the pending batches are those of the last keyframes with inactive
    # geometry before the window
    pending, count_gap = [], 0
    for fid in reversed(start["keyframes"]):
        if len(pending) == len(start["pending"]):
            break
        if len(points(fid)["inactive"][0]):
            pending.insert(0, points(fid)["inactive"])
    count_gap += abs(len(pending) - len(start["pending"])) + sum(
        abs(len(p[0]) - n) for p, n in zip(pending, start["pending"]))
    cache = ref_growth.DepthCache(mp.depth_cache,
                                  mp.min_num_inactive_geo_densify, pending,
                                  start["since"])
    want = []
    for op in g["ops"]:
        batches = []
        for fid in op["fids"]:
            batches += cache.keyframe(points(fid))
        want.append(batches)
        count_gap += abs(op["added"] - sum(len(b[0]) for b in batches))
    row_gap = max([ref_growth.rows_gap(want[r["op"]], r["xyz"], r["f_dc"])
                   for r in g["rows"]], default=float("inf"))
    # the schedule, then the rule on a sampled densification
    it0, it1 = start["iteration"], g["end_iteration"]
    due = ref_growth.densify_due(it0, it1, opt.densify_from_iter,
                                 opt.densify_until_iter,
                                 opt.densification_interval)
    got = list(g["densify_iters"])
    dens_gap = abs((it1 - it0) - kept["frames"] * kept["iters_per_frame"])
    dens_gap += len(set(due) ^ set(got)) + len(got) - len(set(got))
    d = g["densify"]
    if d is not None:
        big = bool(opt.prune_big_point_after_iter) and \
            d["iteration"] > opt.prune_big_point_after_iter
        n_ref = ref_growth.densified_count(
            d["pre"], opt.densify_grad_threshold, opt.densify_min_opacity,
            extent_m, opt.max_screen_size if big else None,
            opt.percent_dense)
        dens_gap += abs(d["after"] - n_ref)
    elif due:
        dens_gap = float("inf")
    return dict(growth_count_gap=float(count_gap), growth_row_gap=row_gap,
                densify_gap=float(dens_gap))


def control_numbers(kept: dict, seq, intr: dict, opt, mp, config: dict,
                    enc_w, dev) -> dict:
    """The numbers the control reads: the reference put in the program's
    place, computed in the precision below the configuration's (the pair
    features in float8 e4m3 for its bfloat16; the encoder in TF32 for its
    float32 with TF32 off), against the reference as it stands."""
    nums = dict(step_loss_gap=0.0, step_color_gap=0.0, step_grad_gap=0.0,
                step_change_gap=0.0)
    for rec in kept["steps"]:
        want = reference_step(rec, seq, intr, opt, mp, config, enc_w, dev)
        low = reference_step(rec, seq, intr, opt, mp, config, enc_w, dev,
                             feat_dtype=torch.float8_e4m3fn)
        fake = dict(pre=rec["pre"], post=dict(params=low["post"]),
                    grads=low["grads"], loss=low["loss"], color=low["color"])
        for k, val in step_numbers(fake, want).items():
            nums[k] = max(nums[k], val)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    lows = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        for index, _ in kept["outputs"]:
            color, _ = scene.decode(seq, index % len(seq))
            lows.append((index, _ref_lf(enc_w, color, config["encoder"],
                                        dev)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    nums["lf_gap"] = lf_gap(lows, seq, enc_w, config["encoder"], dev)
    # the reference's back-projection in bfloat16, for the configuration's
    # float32, in the program's place
    low_rows = _bf16_rows(kept, seq, intr, mp)
    nums["growth_row_gap"] = max(
        [ref_growth.rows_gap(want, xyz, f_dc)
         for want, xyz, f_dc in low_rows], default=float("inf"))
    return nums


def _bf16_rows(kept: dict, seq, intr: dict, mp) -> list:
    """The sampled operations' batches as the reference puts them, beside
    the rows the reference in bfloat16 would have added."""
    g = kept["growth"]
    exact = _keyframe_points(g, seq, intr, mp)
    out = []
    for r in g["rows"]:
        fids = kept["growth"]["ops"][r["op"]]["fids"]
        want = [exact(f)["map"] for f in fids]
        xyz = torch.as_tensor(np.concatenate([w[0] for w in want])).to(
            torch.bfloat16).float()
        f_dc = (torch.as_tensor(np.concatenate([w[1] for w in want]))
                .double() - 0.5) / ref_growth.SH_C0
        out.append((want, xyz, f_dc))
    return out


def compare(kept: dict, seq, intr: dict, opt, mp, config: dict, enc_w,
            dev, limits: dict) -> dict:
    """{number: {"value", "limit"}} over everything the run kept."""
    nums = dict(lf_gap=lf_gap(kept["outputs"], seq, enc_w,
                              config["encoder"], dev),
                ingest_mismatch=ingest_mismatch(kept["keyframes"], seq, mp),
                binning_gap=max([binning_gap(r, seq, intr, config, dev)
                                 for r in kept["binnings"]],
                                default=float("inf")))
    step = dict(step_loss_gap=0.0, step_color_gap=0.0, step_grad_gap=0.0,
                step_change_gap=0.0)
    for rec in kept["steps"]:
        want = reference_step(rec, seq, intr, opt, mp, config, enc_w, dev)
        for k, val in step_numbers(rec, want).items():
            step[k] = max(step[k], val)
    if not kept["steps"]:
        step = {k: float("inf") for k in step}
    nums.update(step)
    nums.update(growth_numbers(
        kept, seq, intr, opt, mp, config,
        extent(seq, config["app"]["kf_stride"], mp.min_num_initial_map_kfs)))
    return {k: dict(value=v, limit=limits[k]) for k, v in nums.items()}
