"""Numeric constants and configuration dataclasses of the port.

A copy of the constants and dataclasses of legslam_tpu/config.py that the
mapping step needs (the port imports nothing from the JAX package).
Parity-critical constants mirror the reference CUDA implementation:
cuda_rasterizer/config.h:15-18, auxiliary.h:21-44, forward.cu:82-357.
"""
from __future__ import annotations

import dataclasses

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
class RasterizeConfig:
    """Static configuration of the tile rasterizer.

    backend: "torch" is the reference compositor written in plain PyTorch
      ops with autograd (the counterpart of legslam_tpu's "xla" backend);
      "cuda" is the hand-written forward and backward compositing kernels
      (the counterpart of "pallas"). On CPU tensors the "cuda" backend
      runs the kernels' plain PyTorch versions.
    mm_dtype: storage type of the gathered pair features read by the
      kernels, "float32" or "bfloat16". Accumulation is always float32.
    power_mode: kept for configuration parity with legslam_tpu, where it
      only chose how the TPU evaluated the same quadratic exponent
      (legslam_tpu/ops/pallas/composite.py:94-130). The port evaluates the
      exponent exactly, per element, as the "vpu" form does, whatever the
      value.
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
    power_mode: str = "vpu"
    mm_dtype: str = "float32"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.mm_dtype not in MM_DTYPES:
            raise ValueError(f"mm_dtype {self.mm_dtype!r} not in {MM_DTYPES}")

    def span(self) -> int:
        return self.max_span_x * self.max_span_y
