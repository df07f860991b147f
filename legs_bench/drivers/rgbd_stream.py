"""Generator of the online RGB-D loop's traffic: a closed loop of frames
through the app's per-frame body, `legslam_torch.apps.replica_rgbd.
process_frame`, with the frontend, the mapper and the encoder built from
the configuration as the app's `main` builds them.

Parameters, from the traffic file: `loop_frames` (frames in one loop of
the path), `iters_per_frame`, `setup_frames` and `setup_iters_per_frame`
(set-up walks this many frames at this many iterations a frame, so the
window meets a store of tens of thousands of gaussians, as a session
that has been running does), `warm_frames` (then frames at the cell's
own iterations), `window_frames_per_s` (the measured window is this
many frames for each second of --seconds: a fixed amount of work, so the
store the window starts from and grows to is the same whatever the
program's speed), `trace_seconds` and `trace_min_frames` (each of the
traced run's two windows), `check_frames`, `check_keyframes`,
`check_iters` and `check_binnings` (the samples the comparison takes),
`launch_samples` and `launch_stride`.
The next frame is taken when the last one is done. After a loop the path
repeats with fresh frame indices.
"""
from __future__ import annotations

import contextlib
import random
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from legs_bench import frozen, loop_check, scene, tracing, weights
from legs_bench.harness import quantile


class Feed:
    """Frames of the stored loop, decoded as the dataset readers decode
    them, with fresh indices past the loop's end."""

    def __init__(self, seq, fps: float):
        from legslam_torch.data.datasets import RGBDFrame
        self.seq, self.fps, self.n, self.make = seq, fps, 0, RGBDFrame

    def next(self):
        i = self.n % len(self.seq)
        color, depth = scene.decode(self.seq, i)
        frame = self.make(index=self.n, timestamp=self.n / self.fps,
                          color=color, depth=depth, c2w=self.seq.c2w[i])
        self.n += 1
        return frame


class StepRecorder:
    """Stands in for legslam_torch.mapper.mapper.train_step while the window
    runs: passes every call through and keeps a seeded reservoir of `k`
    of them, each with copies of the store before and after the step, the
    gradient as the optimizer got it (read at models/gaussians.py
    adam_update's entry) and the step's loss and rendered colour."""

    def __init__(self, real, k: int, seed: int):
        self.real, self.k = real, k
        self.rng = random.Random(seed)
        self.calls = 0
        self.kept = []

    def __call__(self, state, *args, **kw):
        from legslam_torch.models import gaussians as G
        n = self.calls
        self.calls += 1
        slot = n if n < self.k else self.rng.randrange(n + 1)
        if slot >= self.k:
            return self.real(state, *args, **kw)
        pre = loop_check.store_copy(state)
        adam, seen = G.adam_update, {}

        def record_grads(st, grads, *a, **k):
            seen.update({g: getattr(grads, g).detach().clone()
                         for g in loop_check.GROUPS})
            return adam(st, grads, *a, **k)
        G.adam_update = record_grads
        try:
            state, aux = self.real(state, *args, **kw)
        finally:
            G.adam_update = adam
        handed = kw.get("binning")
        rec = dict(pre=pre, post=loop_check.store_copy(state), grads=seen,
                   pairs=None if handed is None else
                   loop_check.pair_list(handed[0]),
                   loss=aux.loss.detach().clone(),
                   color=aux.color.detach().clone(),
                   world_view=args[0].detach().cpu().numpy(),
                   lr_step=float(args[10]), width=kw["width"],
                   height=kw["height"], sh_degree=kw["active_sh_degree"],
                   max_pairs=kw["cfg"].max_pairs)
        if n < self.k:
            self.kept.append(rec)
        else:
            self.kept[slot] = rec
        return state, aux


class BinningRecorder:
    """Stands in for the mapper's binning_for (its cache fills) while the
    window runs: keeps a seeded reservoir of `k` calls, each with a copy of
    the store it binned, the view and the pair list it returned."""

    def __init__(self, mapper, k: int, seed: int):
        self.mapper, self.real, self.k = mapper, mapper.binning_for, k
        self.rng = random.Random(seed + 4)
        self.calls = 0
        self.kept = []

    def __call__(self, view, cfg):
        out = self.real(view, cfg)
        n = self.calls
        self.calls += 1
        slot = n if n < self.k else self.rng.randrange(n + 1)
        if slot < self.k:
            rec = dict(store=loop_check.store_copy(self.mapper.state),
                       world_view=view.world_view.detach().cpu().numpy(),
                       width=view.width, height=view.height,
                       sh_degree=self.mapper.active_sh_degree,
                       max_pairs=cfg.max_pairs,
                       pairs=loop_check.pair_list(out[0]))
            if n < self.k:
                self.kept.append(rec)
            else:
                self.kept[slot] = rec
        return out


class GrowthRecorder:
    """Stands in for the mapper's handle_operation and for
    legslam_torch.models.gaussians.densify_and_prune while the window
    runs. Of every keyframe operation it keeps the keyframes' ids and the
    store's valid count before and after (on the device, read once the
    window has closed); of a seeded one among those that emptied the depth
    cache, and of a seeded one of all, the valid rows before and the
    positions and colours after. Of every densification it keeps the
    mapper's iteration, and of a seeded one the store's inputs to the rule
    and its valid count after. At the start it reads the depth cache's
    pending batches and counter and the mapper's iteration."""

    def __init__(self, mapper, seed: int):
        from legslam_torch.models import gaussians as G
        self.mapper, self.G = mapper, G
        self.real_op, self.real_densify = mapper.handle_operation, \
            G.densify_and_prune
        self.start = dict(pending=[len(p) for p, _, _ in
                                   mapper._depth_cache],
                          since=mapper._kfs_since_densify_flush,
                          iteration=mapper.iteration,
                          keyframes=sorted(mapper.keyframes))
        self.rng = random.Random(seed + 5)
        self.ops, self.densify_iters = [], []
        self.n_flush = self.n_densify = 0
        self.flush_op = self.any_op = self.densify = None

    def __enter__(self):
        self.mapper.handle_operation = self.op
        self.G.densify_and_prune = self.densify_call
        return self

    def __exit__(self, *exc):
        self.mapper.handle_operation = self.real_op
        self.G.densify_and_prune = self.real_densify
        return False

    def _pick(self, n: int) -> bool:
        return n == 0 or self.rng.randrange(n + 1) == 0

    def op(self, op):
        m = self.mapper
        fids = [p.fid for p in (op.keyframes or [])]
        if m.state is None or not fids:
            return self.real_op(op)
        pre_valid = m.state.valid.clone()
        pending = len(m._depth_cache)
        out = self.real_op(op)
        st = m.state
        n = len(self.ops)
        rec = dict(i=n, fids=fids, before=pre_valid.sum(),
                   after=st.valid.sum())
        self.ops.append(rec)

        def rows():
            return dict(rec, pre_valid=pre_valid, valid=st.valid.clone(),
                        xyz=st.params.xyz.detach().clone(),
                        f_dc=st.params.f_dc.detach().clone())
        if self._pick(n):
            self.any_op = rows()
        if pending and len(m._depth_cache) < pending:
            if self._pick(self.n_flush):
                self.flush_op = rows()
            self.n_flush += 1
        return out

    def densify_call(self, state, *args, **kw):
        out = self.real_densify(state, *args, **kw)
        self.densify_iters.append(self.mapper.iteration)
        if self._pick(self.n_densify):
            s = state.stats
            self.densify = dict(
                pre=dict(opacity=state.params.opacity.detach().clone(),
                         scaling=state.params.scaling.detach().clone(),
                         grad_accum=s.grad_accum.clone(),
                         denom=s.denom.clone(),
                         max_radii2d=s.max_radii2d.clone(),
                         valid=state.valid.clone()),
                iteration=self.mapper.iteration, after=out.valid.sum())
        self.n_densify += 1
        return out

    def kept(self) -> dict:
        """What the comparison reads, with the device counts on the host
        and each keyframe's keypoints from the mapper."""
        kps = {f: np.asarray(kf.kp_pixels)
               for f, kf in self.mapper.keyframes.items()
               if kf.kp_pixels is not None}
        ops = [dict(fids=r["fids"],
                    added=int(r["after"]) - int(r["before"]))
               for r in self.ops]
        sampled = []
        for r in (self.flush_op, self.any_op):
            if r is None or any(r is s for s in sampled):
                continue
            sampled.append(r)
        rows = []
        for r in sampled:
            pre = r["pre_valid"]
            new = r["valid"].clone()
            new[:pre.shape[0]] &= ~pre
            idx = torch.nonzero(new).flatten()
            rows.append(dict(op=r["i"], xyz=r["xyz"][idx],
                             f_dc=r["f_dc"][idx]))
        dens = None
        if self.densify is not None:
            dens = dict(self.densify, after=int(self.densify["after"]))
        return dict(start=self.start, ops=ops, rows=rows, keypoints=kps,
                    densify_iters=list(self.densify_iters), densify=dens,
                    end_iteration=self.mapper.iteration)


def build(config: dict, seed: int, dev):
    """The frontend, the mapper and the encoder as the app's main builds
    them from the configuration's files, and the encoder's weights."""
    from legslam_torch.config import (RasterizeConfig, intrinsics_from_yaml,
                                      mapper_params_from_yaml,
                                      optimization_from_yaml)
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import pca as PCA
    from legslam_torch.models.encoder import LanguageFeaturesEncoder
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    app = config["app"]
    intr = intrinsics_from_yaml(config["camera"])
    opt = optimization_from_yaml(config["mapper"])
    mp = mapper_params_from_yaml(config["mapper"])
    rcfg = RasterizeConfig(backend=app["backend"],
                           tile_batch=app["tile_batch"],
                           mm_dtype=app["mm_dtype"])
    frontend = TrajectoryFrontend(intr, kf_stride=app["kf_stride"])
    out_dir = tempfile.mkdtemp(prefix="legs_bench_")
    mapper = GaussianMapper(
        frontend.queue, intr, opt=opt, mp=mp, cfg=rcfg,
        capacity=app["capacity"], result_dir=out_dir, seed=app["seed"],
        max_per_tile=app["max_per_tile"], include_lang_feat=True,
        binning_refresh_interval=app["binning_refresh"], device=dev)
    enc_cfg = config["encoder"]
    dino, pca = weights.make_encoder(seed, dev, enc_cfg)
    dcfg = D.DinoV2Config(
        image_size=enc_cfg["image_size"], patch_size=enc_cfg["patch_size"],
        dim=enc_cfg["dim"], depth=enc_cfg["depth"], heads=enc_cfg["heads"],
        mlp_ratio=enc_cfg["mlp_ratio"],
        num_registers=enc_cfg["num_registers"],
        layer_norm_eps=enc_cfg["layer_norm_eps"],
        pos_grid=enc_cfg["image_size"] // enc_cfg["patch_size"])
    encoder = LanguageFeaturesEncoder(
        dino, PCA.PCAParams(*pca), dcfg,
        dtype=getattr(torch, enc_cfg["dtype"]), device=dev)
    return intr, opt, mp, frontend, mapper, encoder, (dino, pca)


def run(ctx) -> dict:
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.mapper import mapper as mapper_mod
    from legslam_torch.ops.cuda import composite_bwd as cb
    dev, seed, t = ctx.device, ctx.seed, ctx.traffic
    config = ctx.config
    intr, opt, mp, frontend, mapper, encoder, enc_w = build(config, seed,
                                                             dev)
    seq = scene.make_sequence(seed, t["loop_frames"], intr, dev)
    feed = Feed(seq, float(config["camera"]["Camera.fps"]))
    iters = t["iters_per_frame"]

    def step(frame, n=iters):
        return process_frame(frame, frontend, mapper, encoder,
                             iters_per_frame=n)

    # set-up: a session that has been running, then frames at the cell's
    # own rate
    while mapper.state is None or feed.n < t["setup_frames"]:
        step(feed.next(), t["setup_iters_per_frame"])
    for _ in range(t["warm_frames"]):
        step(feed.next())
    tracing.sync(dev)
    setup_s = time.time() - ctx.t_start
    valid0 = int(mapper.state.num_valid())

    spans = tracing.Spans(dev)
    span = spans.span if ctx.trace else (lambda name:
                                         contextlib.nullcontext())
    recorder = StepRecorder(mapper_mod.train_step, t["check_iters"], seed)
    mapper_mod.train_step = recorder
    binnings = BinningRecorder(mapper, t["check_binnings"], seed)
    mapper.binning_for = binnings
    growth = GrowthRecorder(mapper, seed)
    growth.__enter__()
    samplers = []
    if ctx.trace:
        spans.wrap(encoder, "create_language_features", "encoder")
        spans.wrap(frontend, "track", "track")
        spans.wrap(mapper, "drain_operations", "drain")
        spans.wrap(mapper, "initialize_map", "init")
        spans.wrap(mapper, "train_iteration", "map_iter")
        samplers = [tracing.LaunchSampler(cb, name, seed + j,
                                          t["launch_samples"],
                                          t["launch_stride"])
                    for j, name in enumerate(("composite_forward",
                                              "composite_backward"))]
    frame_ms, kf_frames, outputs = [], [], []

    def window(frames=None, seconds=None, min_frames=1):
        """Frames until `frames` are done, or until `seconds` have passed
        and `min_frames` are done; the window's seconds."""
        done = 0
        t_w0 = time.perf_counter()
        while True:
            with span("decode"):
                frame = feed.next()
            t0 = time.perf_counter()
            with span("frame"):
                lf = step(frame)
                tracing.sync(dev)
            t1 = time.perf_counter()
            done += 1
            frame_ms.append((t1 - t0) * 1e3)
            outputs.append((frame.index, lf))
            if frame.index % config["app"]["kf_stride"] == 0:
                kf_frames.append(len(frame_ms) - 1)
            if frames is not None and done >= frames:
                break
            if seconds is not None and t1 - t_w0 >= seconds and \
                    done >= min_frames:
                break
        return time.perf_counter() - t_w0

    launches0 = _launches(cb)
    data = None
    try:
        if not ctx.trace:
            # a fixed amount of work: the same frames, and so the same
            # store, whatever the program's speed
            window_s = window(frames=max(1, round(
                t["window_frames_per_s"] * ctx.seconds)))
        else:
            # the device's part: the layers marked in the trace, nothing
            # synchronised but each frame's end, as in the untraced window
            spans.synced = False
            for s in samplers:
                s.__enter__()
            prof = tracing.profiler()
            prof.__enter__()
            try:
                window_s = window(seconds=t["trace_seconds"],
                                  min_frames=t["trace_min_frames"])
            finally:
                prof.__exit__(None, None, None)
                for s in samplers:
                    s.__exit__(None, None, None)
            launches = {k: v - launches0[k]
                        for k, v in _launches(cb).items()}
            device_frames = len(frame_ms)
            device = tracing.reduce_trace(prof, window_s)
            del prof
            # the layers' host spans, each synchronised at both ends, in a
            # window of their own without the profiler
            spans.synced = True
            b0 = len(frame_ms)
            kf_frames.clear()
            window(seconds=t["trace_seconds"],
                   min_frames=t["trace_min_frames"])
            kf_frames[:] = [i - b0 for i in kf_frames]
    finally:
        mapper_mod.train_step = recorder.real
        mapper.binning_for = binnings.real
        growth.__exit__(None, None, None)
    if not ctx.trace:
        launches = {k: v - launches0[k] for k, v in _launches(cb).items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if ctx.trace:
        data = trace_data(device, spans, samplers, kf_frames, launches,
                          device_frames, config)
    frames = len(frame_ms)
    e2e = dict(frames_per_s=frames / window_s,
               frame_ms_p90=quantile(frame_ms, 0.9), setup_s=setup_s)
    info = dict(frames=frames, window_s=window_s,
                num_valid_start=valid0, capacity=mapper.state.capacity,
                keyframes=sum(1 for i, _ in outputs
                              if i % config["app"]["kf_stride"] == 0),
                launches=launches,
                num_valid_end=int(mapper.state.num_valid()),
                iterations=mapper.iteration, decoded=feed.n,
                frame_ms_median=quantile(frame_ms, 0.5))
    # the comparison, once the window has closed and the peak is read
    kept = dict(steps=recorder.kept, binnings=binnings.kept,
                growth=growth.kept(), frames=frames,
                iters_per_frame=iters,
                keyframes=loop_check.keyframe_copies(
                    mapper, [i for i, _ in outputs
                             if i % config["app"]["kf_stride"] == 0],
                    t["check_keyframes"], seed),
                outputs=loop_check.sample_outputs(outputs,
                                                  t["check_frames"], seed))
    shutil.rmtree(mapper.result_dir, ignore_errors=True)
    del frontend, mapper, encoder, outputs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = loop_check.compare(kept, seq, intr, opt, mp, config, enc_w,
                                dev, ctx.limits)
    control = loop_check.control_numbers(
        kept, seq, intr, opt, mp, config, enc_w, dev) \
        if getattr(ctx, "control", False) else None
    return dict(attempted=frames, failed=0, e2e=e2e, per_layer_data=data,
                control=control,
                info=info, peak=peak, checks=checks,
                breakdown=None if data is None else dict(
                    device_ops=data["device"]["device_ops"],
                    idle_gaps=data["device"]["idle_gaps"]))


def _launches(cb) -> dict:
    from legslam_torch.ops.cuda import composite
    return dict(composite_fwd=composite.composite_forward.launches,
                composite_bwd=cb.composite_backward.launches)


def trace_data(device, spans, samplers, kf_frames, launches, frames,
               config) -> dict:
    """What the per-layer readers read from a traced run: the device's
    part (`device`, the launch samples, the launches and frames of its
    window) and the host spans of the second window (`kf_frames` index
    its frames)."""
    samples = {}
    for s in samplers:
        name = "composite_fwd" if s.attr == "composite_forward" else \
            "composite_bwd"
        rows = []
        for i, args in s.samples:
            if name == "composite_fwd":
                fwd_args = args[:4] + args[4:9]
            else:
                fwd_args = args[:4] + args[8:13]
            b = frozen.bounds(fwd_args, None)
            rows.append(dict(call=i, bound_ms=b[name[-3:]]["bound_ms"],
                             ops=b[name[-3:]]["ops"]))
        samples[name] = dict(calls=s.calls, rows=rows)
    enc = config["encoder"]
    n_patches = (enc["image_size"] // enc["patch_size"]) ** 2
    enc_cfg = SimpleNamespace(**enc)
    ingest = [sum(spans.ms[k][i] for k in ("track", "drain")
                  if i < len(spans.ms[k])) for i in kf_frames]
    return dict(kind="frame", spans=dict(spans.ms), ingest_ms=ingest,
                device=device, launch_samples=samples, launches=launches,
                frames=frames,
                encoder_ops=frozen.encoder_flops(enc_cfg, n_patches,
                                                 enc["pca_dim"]) * frames)
