"""CLI: online RGB-D mapping over a dataset (examples/replica_rgbd.cpp).

Counterpart of legslam_tpu/apps/replica_rgbd.py, with the same flags and
output lines:

  python -m legslam_torch.apps.replica_rgbd \
      --data /path/to/Replica/office0 --out ./output/office0 \
      [--cfg cfg/gaussian_mapper/RGB-D/Replica/office0.yaml] \
      [--camera-cfg cfg/camera/RGB-D/Replica/office0.yaml] \
      [--kf-stride 8] [--max-frames N] [--capacity 262144] [--no-lf] \
      [--encoder-weights <dir with dinov2.npz + pca.npz>] \
      [--frontend trajectory|visual] [--sensor auto|rgbd|mono|stereo|...] \
      [--profile-dir DIR] [--device cuda|cpu]

Prints per-run "Average FPS" and "Total time" lines like the reference
(examples/replica_rgbd.cpp:196-199) and writes the experiment/ply artifact
tree, TrackingTime.txt, GpuPeakUsageMB.txt and the trajectory files. With
--encoder-weights the DINOv2 + PCA encoder computes every frame's 37x37x64
language features on the device (models/encoder.py), and the keyframes
keep them there.

With the default `--frontend trajectory` (the dataset's poses), a stereo
sensor (`--sensor stereo`, or "auto" on a EuRoC layout, whose frames carry
cam1 and no depth) runs one SGM a keyframe on `--device`: the frontend's
map points take their depth from it and the mapper's stereo densify reads
the same disparity. The baseline comes from `--camera-cfg`
(Stereo.T_c1_c2 or Stereo.b), else from the layout's sensor.yaml files.

`--frontend visual` tracks with the KLT + RANSAC frontend
(slam/tracking.py) and GT poses hidden, in the sensor mode of `--sensor`
("auto" sniffs the dataset: stereo pairs, no depth, an IMU stream); its
stereo SGM runs on `--device`. The JAX app's persistent XLA compilation
cache has no counterpart: PyTorch runs eagerly and the kernels are built
once into build/legslam_torch/.

`--profile-dir DIR` traces the feed loop with torch.profiler and turns the
program's spans on (utils/runtime.py): DIR/trace.json holds the CPU and
CUDA events and, as a process of its own above them on the same clock,
"legslam_torch spans": each frame, the encoder, tracking, the drain and
ingest, each mapping iteration with its binning-cache fills and the
step's render, loss, backward and Adam. Open it in Perfetto.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from legslam_torch.utils import runtime


def process_frame(frame, frontend, mapper, encoder=None, lf_image=None,
                  iters_per_frame: int = 1, imu=None):
    """One frame of the online loop, run serially (the reference tracks
    and maps in concurrent threads): the frame's language features (the
    encoder's, else `lf_image`), tracking, the mapper's drain of the
    frontend's operations, map initialization once its conditions hold,
    then `iters_per_frame` mapping iterations. The visual frontend also
    gets the frame's right image and `imu`, the [K, 7] IMU rows since the
    previous frame. Returns the LF image handed to the frontend; the
    encoder's stays on its device, and the keyframe keeps that tensor."""
    from legslam_torch.slam.tracking import TrackingFrontend
    with runtime.span("frame", frame=frame.index) as sp:
        if encoder is not None:
            lf_image = encoder.create_language_features(frame.color)
        if isinstance(frontend, TrackingFrontend):
            packet = frontend.track(
                frame, lf_image=lf_image,
                color_right=getattr(frame, "color_right", None), imu=imu)
        else:
            packet = frontend.track(frame, lf_image=lf_image)
        sp.set(keyframe=packet is not None)
        mapper.drain_operations()
        if mapper.state is None and mapper.has_met_initial_conditions():
            mapper.initialize_map()
        if mapper.state is not None:
            for _ in range(iters_per_frame):
                mapper.train_iteration()
    return lf_image


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True)
    parser.add_argument("--out", default="./output/run")
    parser.add_argument("--cfg", default=None,
                        help="gaussian_mapper YAML (cfg/gaussian_mapper/...)")
    parser.add_argument("--camera-cfg", default=None,
                        help="camera YAML (cfg/camera/...) overriding the "
                             "dataset's intrinsics, incl. dist_coeffs")
    parser.add_argument("--kf-stride", type=int, default=8)
    parser.add_argument("--frontend", default="trajectory",
                        choices=("trajectory", "visual"),
                        help="trajectory = GT-pose playback; visual = "
                        "KLT+RANSAC tracking")
    parser.add_argument("--sensor", default="auto",
                        choices=("auto", "rgbd", "mono", "stereo",
                                 "rgbd-inertial", "mono-inertial",
                                 "stereo-inertial"),
                        help="sensor mode for the mapper densify branch; "
                        "auto sniffs the dataset (stereo pairs -> stereo, "
                        "no depth -> mono, +'-inertial' with an IMU stream)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--capacity", type=int, default=1 << 18)
    parser.add_argument("--iters-per-frame", type=int, default=1)
    parser.add_argument("--encoder-weights", default=None,
                        help="dir with dinov2.npz/pca.npz for the LF "
                        "encoder")
    parser.add_argument("--no-lf", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-per-tile", type=int, default=2048,
                        help="per-tile compositing cap (torch backend)")
    parser.add_argument("--tile-batch", type=int, default=32)
    parser.add_argument("--chunk", type=int, default=None,
                        help="compositing depth-chunk size (default: "
                             "RasterizeConfig.chunk; small scenes can "
                             "drop to 64)")
    parser.add_argument("--max-span-x", type=int, default=None)
    parser.add_argument("--max-span-y", type=int, default=None,
                        help="static per-gaussian tile-span caps "
                             "(pairs beyond them are dropped and counted "
                             "in overflow_pairs)")
    parser.add_argument("--backend", default="cuda",
                        help="compositing backend (cuda|torch)")
    parser.add_argument("--mm-dtype", default=None,
                        help="pair feature type of the cuda kernels "
                        "(bfloat16|float32; default bfloat16 on cuda)")
    parser.add_argument("--n-views", type=int, default=1,
                        help="keyframes per mapping tick (a batched step; "
                             "split over the ranks of a torch.distributed "
                             "group when one is set up)")
    parser.add_argument("--spatial-strips", type=int, default=1,
                        help="tile-row strips each view renders in (split "
                             "over the ranks of a group when one is set "
                             "up)")
    parser.add_argument("--shard-store", action="store_true",
                        help="capacity-shard the store over the ranks of a "
                             "group (the whole store without one)")
    parser.add_argument("--n-buckets", type=int, default=1,
                        help="rank-block buckets of the binning (cuda "
                             "backend; 1 = flat)")
    parser.add_argument("--bucket-cap", type=int, default=None,
                        help="pair capacity of each bucket (a multiple of "
                             "256)")
    parser.add_argument("--p-slabs", type=int, default=0,
                        help="watermark slab skip of the per-gaussian work "
                             "(0 = off)")
    parser.add_argument("--no-ellipse-cull", action="store_true",
                        help="emit every pair of the opacity-aware rect "
                             "(no tile-ellipse cull)")
    parser.add_argument("--binning-refresh", type=int, default=4,
                        help="per-view binning cache interval (1 = exact)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the mapping "
                             "loop, with the program's spans, to this dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the map and the step")
    args = parser.parse_args(argv)

    from legslam_torch.config import MapperParams, RasterizeConfig
    from legslam_torch.data.datasets import open_dataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    from legslam_torch.utils.runtime import profile_trace, save_peak_memory

    device = torch.device(args.device)
    backend = args.backend
    mm = args.mm_dtype or ("bfloat16" if backend == "cuda" else "float32")
    extra = {k: v for k, v in (("chunk", args.chunk),
                               ("max_span_x", args.max_span_x),
                               ("max_span_y", args.max_span_y),
                               ("bucket_cap", args.bucket_cap)) if v}
    cfg = RasterizeConfig(backend=backend, tile_batch=args.tile_batch,
                          mm_dtype=mm, n_buckets=args.n_buckets,
                          p_slabs=args.p_slabs,
                          ellipse_cull=not args.no_ellipse_cull, **extra)
    opt = mp = None
    cam_intr = None
    if args.cfg:
        from legslam_torch.config import load_run_config
        opt, mp, cam_intr = load_run_config(args.cfg, args.camera_cfg)
    elif args.camera_cfg:
        from legslam_torch.config import (intrinsics_from_yaml,
                                          load_opencv_yaml)
        cam_intr = intrinsics_from_yaml(load_opencv_yaml(args.camera_cfg))
    ds = open_dataset(args.data)
    intr = {**ds.intrinsics, **(cam_intr or {})}
    sensor = args.sensor
    if sensor == "auto":
        # loaders with right images are stereo; with no depth, monocular
        # (System.h:67-75 sensor enum)
        probe = ds.read(0)
        if getattr(probe, "color_right", None) is not None:
            sensor = "stereo"
        elif probe.depth is None:
            sensor = "mono"
        else:
            sensor = "rgbd"
        if getattr(ds, "imu_between", None) is not None and \
                getattr(ds, "_imu", None) is not None:
            sensor += "-inertial"
    has_imu = sensor.endswith("-inertial") and \
        getattr(ds, "imu_between", None) is not None
    base_sensor = sensor[:-len("-inertial")] if \
        sensor.endswith("-inertial") else sensor
    if args.frontend == "visual":
        from legslam_torch.slam.tracking import TrackingFrontend
        frontend = TrackingFrontend(
            intr, sensor=sensor,
            stereo_baseline=intr.get("stereo_baseline",
                                     getattr(ds, "baseline", 0.0)),
            device=device)
    else:
        stereo = base_sensor == "stereo"
        if stereo:
            # the mapper's stereo branch reads the baseline from intr
            intr["stereo_baseline"] = intr.get(
                "stereo_baseline", getattr(ds, "baseline", 0.0))
        smp = mp or MapperParams()
        frontend = TrajectoryFrontend(
            intr, kf_stride=args.kf_stride,
            sensor="stereo" if stereo else "rgbd",
            stereo_baseline=intr.get("stereo_baseline", 0.0),
            min_disparity=smp.stereo_min_disparity,
            num_disparity=smp.stereo_num_disparity, device=device)
    mapper = GaussianMapper(frontend.queue, intr, opt=opt, mp=mp, cfg=cfg,
                            capacity=args.capacity, result_dir=args.out,
                            seed=args.seed, max_per_tile=args.max_per_tile,
                            include_lang_feat=not args.no_lf,
                            binning_refresh_interval=args.binning_refresh,
                            n_views=args.n_views,
                            spatial_strips=args.spatial_strips,
                            shard_store=args.shard_store,
                            sensor_type="monocular" if base_sensor == "mono"
                            else base_sensor, device=device)

    encoder = None
    if args.encoder_weights and not args.no_lf:
        from legslam_torch.models.weights_io import load_encoder
        encoder = load_encoder(args.encoder_weights, device=device)

    n = len(ds) if args.max_frames is None else min(len(ds),
                                                    args.max_frames)
    track_times = []
    prof = profile_trace(args.profile_dir) if args.profile_dir else \
        contextlib.nullcontext()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    it = iter(ds.iter_prefetched())
    with prof:
        for i in range(n):
            frame = next(it)
            t0 = time.perf_counter()
            process_frame(frame, frontend, mapper, encoder,
                          iters_per_frame=args.iters_per_frame,
                          imu=ds.imu_between(i) if has_imu else None)
            track_times.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_start
    frontend.finish()

    # short sequences may never hit min_num_initial_map_kfs while feeding;
    # the feed is done now, so force initialization from whatever arrived
    mapper.drain_operations(limit=10_000)
    if mapper.state is None and len(mapper.keyframes):
        mapper.initialize_map()

    # tail optimization + artifacts (gaussian_mapper.cpp:538-553)
    for _ in range(int(0.8 * mapper.opt.densification_interval)):
        mapper.train_iteration()
    base = mapper.save("experiment")
    stats = mapper.record_keyframe_metrics("experiment")

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "TrackingTime.txt"), "w") as f:
        f.writelines(f"{t}\n" for t in track_times)
    save_peak_memory(os.path.join(args.out, "GpuPeakUsageMB.txt"), device)
    # trajectory artifacts in all three reference formats
    # (System::SaveTrajectoryTUM/EuRoC/KITTI, examples/replica_rgbd.cpp:
    # 208-218; GT-pose frontend: poses are the input poses)
    from legslam_torch.utils.trajectory_io import (save_trajectory_euroc,
                                                   save_trajectory_kitti,
                                                   save_trajectory_tum)
    stamps, c2ws = [], []
    for fid, kf in sorted(mapper.keyframes.items()):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = kf.R.T
        T[:3, 3] = -(kf.R.T @ kf.t)
        stamps.append(kf.timestamp)
        c2ws.append(T)
    save_trajectory_tum(
        os.path.join(args.out, "CameraTrajectory_TUM.txt"), stamps, c2ws)
    save_trajectory_euroc(
        os.path.join(args.out, "CameraTrajectory_EuRoC.txt"), stamps, c2ws)
    save_trajectory_kitti(
        os.path.join(args.out, "CameraTrajectory_KITTI.txt"), stamps, c2ws)

    print(f"Total time: {total:.2f}")
    print(f"Average FPS: {n / total:.3f}")
    print(f"Keyframes: {len(mapper.keyframes)}  "
          f"Gaussians: {int(mapper.state.num_valid())}  "
          f"Iterations: {mapper.iteration}")
    print(f"PSNR-GS: {stats['psnr']:.2f}  DSSIM: {stats['dssim']:.4f}  "
          f"render: {stats['render_ms']:.1f} ms")
    print(f"Artifacts: {base}")


if __name__ == "__main__":
    main()
