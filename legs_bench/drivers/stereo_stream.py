"""Generator of the online stereo loop's traffic: a closed loop of
rectified grey stereo pairs through the app's per-frame body,
`legslam_torch.apps.replica_rgbd.process_frame`, with the frontend, the
mapper and the encoder built as the app's `main` builds them for a EuRoC
layout on the default frontend (`--sensor stereo`): the trajectory
frontend in stereo mode, one SGM a keyframe, and the mapper's stereo
branch reading that disparity.

Parameters, from the traffic file: those of legs_bench/drivers/
rgbd_stream.py, whose loop this is, and `rehearsal`: on the CPU (the
benchmark's tests; a measured run needs a card) its "traffic" values
replace the file's and its "mapper" values the configuration's, so a
tiny room lands in the disparity range.

The frames: the benchmark's room (legs_bench/scene.py) along its path,
each pose ray-cast twice, the right camera `stereo_baseline` along the
left's x axis (an already rectified pinhole pair), each view stored as
8-bit grey and decoded into three channels as the EuRoC reader decodes
cam0 and cam1. No depth image. The comparison is legs_bench/
stereo_check.py.
"""
from __future__ import annotations

import contextlib
import copy
import random
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from legs_bench import scene, stereo_check, tracing, weights
from legs_bench.drivers import rgbd_stream as rgbd
from legs_bench.harness import quantile
from legs_bench.loop_check import keyframe_copies, sample_outputs
from legs_bench.reference.stereo import LUMA, keypoint_disparity
from legs_bench.sgm_bound import sgm_bound


@dataclass
class StereoSequence(scene.Sequence):
    """One loop of stereo frames on the host: `color` the left view's grey
    in three channels, `depth` zero (a stereo keyframe's depth target),
    `right` the right view's grey [N, H, W] uint8."""
    right: np.ndarray


def make_stereo_sequence(seed: int, n_frames: int, intr: dict,
                         baseline: float, device,
                         fps: float) -> StereoSequence:
    """Ray-cast one loop of the path as a rectified pair, stored as 8-bit
    grey (BT.601 luma of the room's colour)."""
    room = scene.make_room(seed, device)
    poses = scene.camera_path(seed, n_frames)
    w, h = int(intr["width"]), int(intr["height"])
    shift = np.eye(4)
    shift[0, 3] = baseline
    luma = torch.tensor(LUMA, device=device)
    views = np.empty((2, n_frames, h, w), np.uint8)
    for i in range(n_frames):
        for k, pose in enumerate((poses[i], poses[i] @ shift)):
            rgb, _ = scene.cast(room, pose, w, h, intr["fx"], intr["fy"],
                                intr["cx"], intr["cy"])
            views[k, i] = ((rgb @ luma) * 255.0 + 0.5).to(
                torch.uint8).cpu().numpy()
    return StereoSequence(
        color=np.broadcast_to(views[0][..., None], (n_frames, h, w, 3)),
        depth=np.broadcast_to(np.zeros((1, h, w), np.uint16),
                              (n_frames, h, w)),
        c2w=poses, depth_factor=1.0, fps=fps, right=views[1])


class Feed:
    """Frames of the stored loop as the EuRoC reader gives them, with fresh
    indices past the loop's end."""

    def __init__(self, seq: StereoSequence):
        from legslam_torch.data.datasets import RGBDFrame
        self.seq, self.n, self.make = seq, 0, RGBDFrame

    def next(self):
        i = self.n % len(self.seq)
        color, _ = scene.decode(self.seq, i)
        right = np.repeat(self.seq.right[i][..., None], 3, -1).astype(
            np.float32) / np.float32(255.0)
        frame = self.make(index=self.n, timestamp=self.n / self.seq.fps,
                          color=color, depth=None, c2w=self.seq.c2w[i],
                          color_right=right)
        self.n += 1
        return frame


def build(config: dict, seed: int, dev):
    """The stereo frontend, the mapper and the encoder as the app's main
    builds them from the configuration's files (the camera without its
    distortion: the pair is rectified), and the encoder's weights."""
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
    intr.pop("dist_coeffs", None)
    opt = optimization_from_yaml(config["mapper"])
    mp = mapper_params_from_yaml(config["mapper"])
    frontend = TrajectoryFrontend(
        intr, kf_stride=app["kf_stride"], sensor="stereo",
        stereo_baseline=intr["stereo_baseline"],
        min_disparity=mp.stereo_min_disparity,
        num_disparity=mp.stereo_num_disparity, device=dev)
    rcfg = RasterizeConfig(backend=app["backend"],
                           tile_batch=app["tile_batch"],
                           mm_dtype=app["mm_dtype"])
    out_dir = tempfile.mkdtemp(prefix="legs_bench_")
    mapper = GaussianMapper(
        frontend.queue, intr, opt=opt, mp=mp, cfg=rcfg,
        capacity=app["capacity"], result_dir=out_dir, seed=app["seed"],
        max_per_tile=app["max_per_tile"], include_lang_feat=True,
        binning_refresh_interval=app["binning_refresh"],
        sensor_type="stereo", device=dev)
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


class DisparityRecorder:
    """Stands in for the frontend's track: passes every call through and
    keeps each keyframe packet's disparity by frame id (the tensor itself,
    read once the window has closed)."""

    def __init__(self, frontend):
        self.real = frontend.track
        self.kept = {}
        frontend.track = self

    def __call__(self, frame, *a, **kw):
        packet = self.real(frame, *a, **kw)
        if packet is not None:
            self.kept[packet.fid] = packet.disparity
        return packet


class SgmCounter:
    """Stands in for legslam_torch.ops.stereo.sgm_disparity (every caller
    looks it up on the module) while the window runs: counts the calls,
    and with `span`, marks each in the benchmark's spans as "sgm"."""

    def __init__(self, span=None):
        from legslam_torch.ops import stereo
        self.module, self.real, self.span = stereo, stereo.sgm_disparity, \
            span
        self.calls = 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.span is None:
            return self.real(*a, **kw)
        with self.span("sgm"):
            return self.real(*a, **kw)

    def __enter__(self):
        self.module.sgm_disparity = self
        return self

    def __exit__(self, *exc):
        self.module.sgm_disparity = self.real
        return False


def sgm_device(prof) -> dict:
    """The SGMs of a profiled window: the "sgm" marks that the trace holds
    whole, the device operations whose launch (the CUDA API call of the
    same correlation id) lies inside one, and their device ms."""
    events = []
    for e in prof.profiler.kineto_results.events():
        dev_type = str(e.device_type())
        start = int(e.start_ns())
        events.append((e.name(), "CUDA" in dev_type or "GPU" in dev_type,
                       start, start + int(e.duration_ns()),
                       int(e.correlation_id())))
    marks = sorted((s, t) for n, is_dev, s, t, _ in events
                   if not is_dev and n == "legs_bench.sgm")
    host = {c: s for n, is_dev, s, _, c in events
            if not is_dev and n.startswith("cu")}
    launches, device_ns = 0, 0
    for n, is_dev, s, t, c in events:
        if not is_dev or n.startswith("legs_bench.") or t <= s or \
                c not in host:
            continue
        at = host[c]
        if any(a <= at <= b for a, b in marks):
            launches += 1
            device_ns += t - s
    return dict(calls=len(marks), launches=launches,
                device_ms=device_ns / 1e6)


def run(ctx) -> dict:
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.mapper import mapper as mapper_mod
    from legslam_torch.ops.cuda import composite_bwd as cb
    dev, seed = ctx.device, ctx.seed
    t, config = dict(ctx.traffic), copy.deepcopy(ctx.config)
    if dev.type == "cpu":
        t.update(t["rehearsal"]["traffic"])
        config["mapper"].update(t["rehearsal"]["mapper"])
    intr, opt, mp, frontend, mapper, encoder, enc_w = build(config, seed,
                                                             dev)
    baseline = intr["stereo_baseline"]
    seq = make_stereo_sequence(seed, t["loop_frames"], intr, baseline, dev,
                               float(config["camera"]["Camera.fps"]))
    feed = Feed(seq)
    iters = t["iters_per_frame"]
    stride = config["app"]["kf_stride"]
    disparities = DisparityRecorder(frontend)

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
    recorder = rgbd.StepRecorder(mapper_mod.train_step, t["check_iters"],
                                 seed)
    mapper_mod.train_step = recorder
    binnings = rgbd.BinningRecorder(mapper, t["check_binnings"], seed)
    mapper.binning_for = binnings
    growth = rgbd.GrowthRecorder(mapper, seed)
    growth.__enter__()
    sgms = SgmCounter(spans.span if ctx.trace else None)
    sgms.__enter__()
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
            if frame.index % stride == 0:
                kf_frames.append(len(frame_ms) - 1)
            if frames is not None and done >= frames:
                break
            if seconds is not None and t1 - t_w0 >= seconds and \
                    done >= min_frames:
                break
        return time.perf_counter() - t_w0

    launches0 = rgbd._launches(cb)
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
                        for k, v in rgbd._launches(cb).items()}
            device_frames = len(frame_ms)
            device = tracing.reduce_trace(prof, window_s)
            sgm_dev = sgm_device(prof)
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
        sgms.__exit__(None, None, None)
    if not ctx.trace:
        launches = {k: v - launches0[k]
                    for k, v in rgbd._launches(cb).items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if ctx.trace:
        data = rgbd.trace_data(device, spans, samplers, kf_frames, launches,
                               device_frames, config)
        data["sgm"] = dict(sgm_dev, bound=sgm_bound(
            int(intr["height"]), int(intr["width"]),
            mp.stereo_num_disparity))
    frames = len(frame_ms)
    window_kfs = [i for i, _ in outputs if i % stride == 0]
    e2e = dict(frames_per_s=frames / window_s,
               frame_ms_p90=quantile(frame_ms, 0.9), setup_s=setup_s)
    info = dict(frames=frames, window_s=window_s,
                num_valid_start=valid0, capacity=mapper.state.capacity,
                keyframes=len(window_kfs), sgm_calls=sgms.calls,
                launches=launches,
                num_valid_end=int(mapper.state.num_valid()),
                iterations=mapper.iteration, decoded=feed.n,
                frame_ms_median=quantile(frame_ms, 0.5),
                frame_ms_keyframe_median=quantile(
                    [frame_ms[i] for i in kf_frames], 0.5))
    # the comparison, once the window has closed and the peak is read
    growth_kept = growth.kept()
    held = [f for f in window_kfs if f in disparities.kept]
    picked = random.Random(seed + 6).sample(held, min(2, len(held)))
    stereo = dict(
        baseline=baseline, sgm_calls=sgms.calls, keyframes=len(window_kfs),
        kp_disparity={f: keypoint_disparity(
            kp, disparities.kept[f].cpu().numpy())
            for f, kp in growth_kept["keypoints"].items()
            if f in disparities.kept},
        samples=[(f, disparities.kept[f].cpu().numpy()) for f in picked])
    kept = dict(steps=recorder.kept, binnings=binnings.kept,
                growth=growth_kept, frames=frames, iters_per_frame=iters,
                stereo=stereo,
                keyframes=keyframe_copies(mapper, window_kfs,
                                          t["check_keyframes"], seed),
                outputs=sample_outputs(outputs, t["check_frames"], seed))
    shutil.rmtree(mapper.result_dir, ignore_errors=True)
    del frontend, mapper, encoder, outputs, disparities
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = stereo_check.compare(kept, seq, intr, opt, mp, config, enc_w,
                                  dev, ctx.limits)
    control = stereo_check.control_numbers(
        kept, seq, intr, opt, mp, config, enc_w, dev) \
        if getattr(ctx, "control", False) else None
    return dict(attempted=frames, failed=0, e2e=e2e, per_layer_data=data,
                control=control, info=info, peak=peak, checks=checks,
                breakdown=None if data is None else dict(
                    device_ops=data["device"]["device_ops"],
                    idle_gaps=data["device"]["idle_gaps"]))

