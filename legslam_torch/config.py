"""Numeric constants and configuration dataclasses of the port.

A copy of the constants, dataclasses and YAML loaders of
legslam_tpu/config.py that the mapping step and the online mapper need
(the port imports nothing from the JAX package).
Parity-critical constants mirror the reference CUDA implementation:
cuda_rasterizer/config.h:15-18, auxiliary.h:21-44, forward.cu:82-357.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# Rasterizer constants (reference: cuda_rasterizer/config.h, auxiliary.h)
LF_CHANNELS = 64          # language-feature channels
SH_DEGREE_MAX = 3
SH_COEFFS_MAX = (SH_DEGREE_MAX + 1) ** 2  # 16

# Compositing tile. 16x128 keeps binning bit-equal to legslam_tpu.
TILE_H = 16
TILE_W = 128

# Numerical guards (forward.cu)
COV2D_LOWPASS = 0.3       # added to cov2D diagonal       (forward.cu:110-111)
VIEW_CLAMP = 1.3          # t.xy clamp factor * tanfov    (forward.cu:82-87)
PROJ_W_EPS = 1e-7         # p_w = 1/(p_hom.w + 1e-7)      (forward.cu:199)
NEAR_CLIP = 0.2           # frustum near-cull             (auxiliary.h:154)
ALPHA_MAX = 0.99          # alpha clamp                   (forward.cu:344)
ALPHA_MIN = 1.0 / 255.0   # alpha skip threshold          (forward.cu:345)
T_TERMINATE = 1e-4        # transmittance termination     (forward.cu:353-357)
RADIUS_EIG_GUARD = 0.1    # max(0.1, mid^2 - det)         (forward.cu:230-231)

# Spherical harmonics constants (auxiliary.h:21-38)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

# Model init (gaussian_model.cpp:156-167)
INIT_OPACITY = 0.1            # stored as inverse_sigmoid(0.1)
KNN_DIST_CLAMP = 1e-7         # clamp_min on mean 3-NN sq dist before log-scale

# Loss (gaussian_mapper.cpp:716-721, loss_utils.h)
SSIM_WINDOW = 11
SSIM_SIGMA = 1.5
SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2

# Camera projection (gaussian_keyframe.cpp:171-192)
Z_NEAR = 0.01
Z_FAR = 100.0

# Language encoder (cfg/encoder/pca_encoder_scannet.yaml, encoder_models.cpp)
ENCODER_INPUT_SIZE = 518
ENCODER_PATCH = 14
ENCODER_GRID = 37             # 518 / 14
ENCODER_TOKENS = 1369         # 37 * 37
ENCODER_FEAT_DIM = 768
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BACKENDS = ("torch", "cuda")
MM_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """Training hyperparameters (reference: gaussian_parameters.cpp /
    cfg/gaussian_mapper/RGB-D/Replica/replica_rgbd.yaml defaults)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    # the reference never reads this from YAML; it keeps the ctor default
    # (gaussian_parameters.h:65: language_feature_lr = 0.0015f)
    lang_feature_lr: float = 0.0015
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    densify_min_opacity: float = 0.02  # min_opacity at prune (gaussian_mapper.cpp:751)
    prune_big_point_after_iter: int = 0
    max_screen_size: float = 20.0      # radii2D prune threshold px
    extent_scale_prune: float = 0.1    # scale > 0.1*extent prune rule
    sh_degree: int = 3
    sh_degree_interval: int = 1000     # +1 active degree every N iters
    adam_eps: float = 1e-15
    # f_rest LR = feature_lr / 20 (gaussian_model.cpp:488-511)


@dataclasses.dataclass(frozen=True)
class MapperParams:
    """Online mapper parameters (gaussian_mapper.cpp:223-359 config surface)."""

    min_num_initial_map_kfs: int = 15
    new_keyframe_times_of_use: int = 8
    local_BA_increased_times_of_use: int = 0
    loop_closure_increased_times_of_use: int = 2
    cull_keyframes: bool = True
    large_rot_th: float = 20.0
    large_trans_th: float = 0.5
    stable_num_iter_existence: int = 30
    do_gaus_pyramid_training: bool = True
    num_gaus_pyramid_sub_levels: int = 2
    gaus_pyramid_times_of_use: tuple = (8, 8)
    do_inactive_geo_densify: bool = True
    depth_cache: int = 10
    min_num_inactive_geo_densify: int = 30
    max_depth_cached: int = 10
    rgbd_min_depth: float = 1e-10
    rgbd_max_depth: float = 40.0
    # Monocular.inactive_geo_densify_max_pixel_dist (squared-dist units in
    # the reference YAML comment; we treat it as pixels)
    mono_max_pixel_dist: float = 1.0
    # Stereo.min_disparity / Stereo.num_disparity (SGM window)
    stereo_min_disparity: int = 8
    stereo_num_disparity: int = 128
    position_lr_max_steps_slam: int = 24   # per-KF use-count LR clamp
    keep_training_after_shutdown: bool = False
    # Screen-radius cap (px) applied to the 3-NN scale init of INGESTED
    # points: a sparse per-keyframe corner cloud (~1k points) has 3-NN
    # distances that init gaussians with 100+ px footprints, which the
    # static tile-span caps then truncate (measured 98% of their pair
    # candidates dropped). The reference prunes any gaussian past
    # size_th=20 px once big-point pruning is armed
    # (gaussian_mapper.cpp:737-755, gaussian_model.cpp:806-826), so the
    # cap enforces at creation the bound training converges to anyway.
    # 0 disables (raw distCUDA2 init, reference create semantics).
    ingest_scale_clamp_px: float = 20.0


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static configuration of the tile rasterizer.

    backend: the compositor. "torch" is the reference compositor written
      in plain PyTorch ops with autograd (the counterpart of legslam_tpu's
      "xla" backend); "cuda" is the hand-written forward and backward
      compositing kernels (the counterpart of "pallas"). On CPU tensors
      the "cuda" backend runs the kernels' plain PyTorch versions. Under
      either backend the render prologue (projection, EWA conic, radius,
      SH colour, the feature matrix: ops/cuda/prologue.py) goes by the
      device: CUDA tensors take its kernel pair, with a hand-written
      backward, and CPU tensors its plain twin.
    mm_dtype: storage type of the gathered pair features read by the
      kernels, "float32" or "bfloat16". Accumulation is always float32.
    """

    tile_h: int = TILE_H
    tile_w: int = TILE_W
    # per-gaussian static tile-span cap (pairs beyond are dropped)
    max_span_x: int = 4
    max_span_y: int = 8
    # pairs per chunk; the unit of the kernels' kfin termination watermark
    chunk: int = 256
    # tiles per batch of the "torch" compositor (a memory knob)
    tile_batch: int = 32
    backend: str = "torch"
    # cap of gathered pair rows for the "cuda" backend
    max_pairs: int = 1 << 20
    mm_dtype: str = "float32"
    # sort binning's depth order and pair keys with the hand-written
    # radix sort kernels (ops/cuda/sort.py), the counterpart of
    # legslam_tpu's pallas_sort. On by default: on the H100 both beat
    # torch.sort at the main path's shapes (PERF.md). Ties come out in
    # the order of a stable sort, so the Binning is the same bit for bit
    # either way.
    cuda_sort: bool = True
    # rank-block bucketed binning ("cuda" backend): the depth ranks split
    # into n_buckets contiguous blocks, each block's pairs sorted on its
    # own, and the compositing kernels walk a tile's n_buckets ranges in
    # order (ops/binning.py bin_gaussians_bucketed); 1 = the flat layout
    n_buckets: int = 1
    # pair capacity of each bucket (a multiple of 256); only read when
    # n_buckets > 1. The kernels read n_buckets * bucket_cap pair rows.
    bucket_cap: int = 1 << 16
    # watermark slab skip of the per-gaussian work (the render prologue,
    # Adam, the densify statistics): it runs on the prefix of whole
    # capacity / p_slabs slabs that covers every valid row
    # (ops/slabs.py). Exact: rows above the watermark are invalid, with
    # zero moments and zero gradients. 0 = off; a capacity that p_slabs
    # does not divide runs in full.
    p_slabs: int = 0
    # the exact anisotropic tile-ellipse pair cull in binning
    # (_corner_cull): render-exact, since a culled pair cannot clear the
    # kernels' alpha keep mask anywhere in its tile; False emits every
    # pair of the opacity-aware rect
    ellipse_cull: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.mm_dtype not in MM_DTYPES:
            raise ValueError(f"mm_dtype {self.mm_dtype!r} not in {MM_DTYPES}")
        if self.n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {self.n_buckets}")
        if self.n_buckets > 1 and (self.bucket_cap <= 0 or
                                   self.bucket_cap % 256):
            raise ValueError("bucket_cap must be a positive multiple of "
                             f"256, got {self.bucket_cap}")
        if self.p_slabs < 0:
            raise ValueError(f"p_slabs must be >= 0, got {self.p_slabs}")

    def span(self) -> int:
        return self.max_span_x * self.max_span_y


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value in ("true", "True"):
        return True
    if value in ("false", "False"):
        return False
    return value


def load_opencv_yaml(path: str) -> dict:
    """Parse the reference's OpenCV FileStorage YAML ("%YAML:1.0") configs.

    Reference read sites: src/gaussian_mapper.cpp:223-359. OpenCV YAML is not
    valid YAML 1.1 (the "%YAML:1.0" directive and bare keys with dots), so we
    parse the `key: value` lines directly.
    """
    out: dict = {}
    with open(path, "r") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].strip()
        i += 1
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        if ":" not in line:
            continue
        key, _, value = line.partition(":")
        key, value = key.strip(), value.strip().strip('"')
        if value == "!!opencv-matrix":
            # multi-line matrix block (rows/cols/dt/data, data may wrap;
            # cv::FileStorage syntax, e.g. Stereo.T_c1_c2 in
            # cfg/ORB_SLAM3/Stereo/EuRoC/EuRoC.yaml)
            rows = cols = 0
            buf = ""
            in_data = False
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].strip()
                if not in_data and sub and not sub.startswith(
                        ("rows:", "cols:", "dt:", "data:")):
                    break
                i += 1
                if sub.startswith("rows:"):
                    rows = int(sub.split(":", 1)[1])
                elif sub.startswith("cols:"):
                    cols = int(sub.split(":", 1)[1])
                elif sub.startswith("data:"):
                    in_data = True
                    buf += sub.split(":", 1)[1]
                elif in_data:
                    buf += " " + sub
                if in_data and "]" in buf:
                    break
            vals = [float(v) for v in
                    buf.strip().lstrip("[").rstrip("]").replace(",", " ")
                    .split()]
            out[key] = np.asarray(vals, np.float64).reshape(rows, cols)
            continue
        if not value:
            continue
        out[key] = _coerce(value)
    return out


def optimization_from_yaml(cfg: dict) -> OptimizationParams:
    """OptimizationParams from a gaussian_mapper YAML dict (read-site
    parity: src/gaussian_mapper.cpp:313-359 key names). Missing keys keep
    the dataclass defaults; language_feature_lr intentionally has no YAML
    key (the reference never reads one)."""
    m = {
        "iterations": "Optimization.max_num_iterations",
        "position_lr_init": "Optimization.position_lr_init",
        "position_lr_final": "Optimization.position_lr_final",
        "position_lr_delay_mult": "Optimization.position_lr_delay_mult",
        "position_lr_max_steps": "Optimization.position_lr_max_steps",
        "feature_lr": "Optimization.feature_lr",
        "opacity_lr": "Optimization.opacity_lr",
        "scaling_lr": "Optimization.scaling_lr",
        "rotation_lr": "Optimization.rotation_lr",
        "percent_dense": "Optimization.percent_dense",
        "lambda_dssim": "Optimization.lambda_dssim",
        "densification_interval": "Optimization.densification_interval",
        "opacity_reset_interval": "Optimization.opacity_reset_interval",
        "prune_big_point_after_iter":
            "Optimization.prune_big_point_after_iter",
        "densify_min_opacity": "Optimization.densify_min_opacity",
        "densify_from_iter": "Optimization.densify_from_iter",
        "densify_until_iter": "Optimization.densify_until_iter",
        "densify_grad_threshold": "Optimization.densify_grad_threshold",
        "sh_degree": "Model.sh_degree",
    }
    kw = {f: cfg[k] for f, k in m.items() if k in cfg}
    return OptimizationParams(**kw)


def mapper_params_from_yaml(cfg: dict) -> MapperParams:
    """MapperParams from a gaussian_mapper YAML dict
    (src/gaussian_mapper.cpp:241-297 key names; note the reference's key
    `Mapper.loop_closure_increased_times_of_use_` trailing underscore)."""
    kw: dict = {}
    scalar = {
        "min_num_initial_map_kfs": "Mapper.min_num_initial_map_kfs",
        "new_keyframe_times_of_use": "Mapper.new_keyframe_times_of_use",
        "local_BA_increased_times_of_use":
            "Mapper.local_BA_increased_times_of_use",
        "loop_closure_increased_times_of_use":
            "Mapper.loop_closure_increased_times_of_use_",
        "large_rot_th": "Mapper.large_rotation_threshold",
        "large_trans_th": "Mapper.large_translation_threshold",
        "stable_num_iter_existence": "Mapper.stable_num_iter_existence",
        "depth_cache": "Mapper.depth_cache",
        "num_gaus_pyramid_sub_levels": "GausPyramid.num_sub_levels",
        "rgbd_min_depth": "RGBD.min_depth",
        "rgbd_max_depth": "RGBD.max_depth",
        "mono_max_pixel_dist":
            "Monocular.inactive_geo_densify_max_pixel_dist",
        "stereo_min_disparity": "Stereo.min_disparity",
        "stereo_num_disparity": "Stereo.num_disparity",
        "position_lr_max_steps_slam": "Optimization.position_lr_max_steps",
    }
    for f, k in scalar.items():
        if k in cfg:
            kw[f] = cfg[k]
    for f, k in (("cull_keyframes", "Mapper.cull_keyframes"),
                 ("do_inactive_geo_densify", "Mapper.inactive_geo_densify"),
                 ("do_gaus_pyramid_training", "GausPyramid.do")):
        if k in cfg:
            kw[f] = bool(cfg[k])
    n_sub = kw.get("num_gaus_pyramid_sub_levels",
                   MapperParams.num_gaus_pyramid_sub_levels)
    tou = cfg.get("GausPyramid.sub_level_times_of_use")
    if tou is not None:
        kw["gaus_pyramid_times_of_use"] = (int(tou),) * int(n_sub)
    return MapperParams(**kw)


def intrinsics_from_yaml(cfg: dict) -> dict:
    """Intrinsics dict from a camera YAML (Camera1.* key names as in
    cfg/ORB_SLAM3/RGB-D/*/*.yaml). Includes dist_coeffs when any of
    k1/k2/p1/p2/k3 is nonzero and depth_scale from RGBD.DepthMapFactor."""
    intr = dict(
        fx=float(cfg["Camera1.fx"]), fy=float(cfg["Camera1.fy"]),
        cx=float(cfg["Camera1.cx"]), cy=float(cfg["Camera1.cy"]),
        width=int(cfg["Camera.width"]), height=int(cfg["Camera.height"]))
    dist = tuple(float(cfg.get(f"Camera1.{k}", 0.0))
                 for k in ("k1", "k2", "p1", "p2", "k3"))
    if any(dist):
        intr["dist_coeffs"] = dist
    if "RGBD.DepthMapFactor" in cfg:
        intr["depth_scale"] = float(cfg["RGBD.DepthMapFactor"])
    if "Stereo.b" in cfg:
        intr["stereo_baseline"] = float(cfg["Stereo.b"])
    elif "Stereo.T_c1_c2" in cfg:
        # EuRoC-style extrinsic calibration: baseline = ||translation||
        # of the cam1->cam2 transform (cfg/ORB_SLAM3/Stereo/EuRoC/
        # EuRoC.yaml Stereo.T_c1_c2)
        T = np.asarray(cfg["Stereo.T_c1_c2"], np.float64)
        intr["stereo_baseline"] = float(np.linalg.norm(T[:3, 3]))
    return intr


def load_run_config(mapper_yaml: str, camera_yaml: str | None = None
                    ) -> tuple[OptimizationParams, MapperParams,
                               dict | None]:
    """Load (OptimizationParams, MapperParams, intrinsics-or-None) from the
    cfg tree, the equivalent of GaussianMapper::readConfigFromFile +
    the ORB-SLAM3 settings read (gaussian_mapper.cpp:223-359, 100-176)."""
    d = load_opencv_yaml(mapper_yaml)
    intr = intrinsics_from_yaml(load_opencv_yaml(camera_yaml)) \
        if camera_yaml else None
    return optimization_from_yaml(d), mapper_params_from_yaml(d), intr
