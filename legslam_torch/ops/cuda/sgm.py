"""Semi-global matching in three kernel launches: census, the four path
scans with the Hamming cost computed on the fly, and winner-take-all.

Replaces no TPU kernel: the JAX package writes SGM as jnp code and
lax.scans (legslam_tpu/ops/stereo.py), and the port's plain version,
ops/stereo.py's sgm_aggregate and disparity_from_aggregate, ran eagerly
at ~10,000 launches an SGM at 752x480 with 128 disparities, whose host
time paced a keyframe frame (PERF.md section 5). The kernels are CUDA C++
for sm_90a (legslam_torch/csrc/sgm.cu); their disparity equals the plain
version's bit for bit.

`sgm` is reached only through ops/stereo.sgm_disparity, which takes it for
CUDA tensors and the plain version for CPU tensors; it raises for other
devices. `sgm.launches` counts its kernel launches, three a call. Spans
(utils/runtime.py): `sgm.census`, `sgm.aggregate` and `sgm.disparity`
around the three launches, inside sgm_disparity's `stereo.sgm`.
"""
from __future__ import annotations

import ctypes

import torch

from legslam_torch.utils import runtime

MAX_DISP = 256
CENSUS_BITS = 24     # the largest Hamming cost


def path_bits(p2: int) -> int:
    """Bits of one path's stored cost: its largest value is
    CENSUS_BITS + p2, kept in 8 bits while that fits, else in 16."""
    top = CENSUS_BITS + p2
    if top <= 0xFF:
        return 8
    if top <= 0xFFFF:
        return 16
    raise ValueError(f"P2 {p2}: a path cost of {top} does not fit 16 bits")


def lanes(num_disp: int) -> int:
    """Disparities a lane holds: num_disp / 32 rounded up to 1, 2, 4 or
    8."""
    if not 1 <= num_disp <= MAX_DISP:
        raise ValueError(f"{num_disp} disparities outside [1, {MAX_DISP}]")
    k = 1
    while 32 * k < num_disp:
        k *= 2
    return k


def _penalty(name: str, value) -> int:
    """A penalty as the kernels take it: a non-negative integer (the plain
    version's float32 sums are then exact integers too)."""
    if value != int(value) or value < 0:
        raise ValueError(f"{name} {value}: the kernels take non-negative "
                         "integer penalties")
    return int(value)


def sgm(left_gray: torch.Tensor, right_gray: torch.Tensor,
        num_disp: int = 128, min_disp: int = 8, p1: float = 10.0,
        p2: float = 120.0) -> torch.Tensor:
    """The [H, W] float32 disparity of a CUDA grey pair [H, W], as
    ops/stereo.sgm_disparity's plain version computes it: -1 outside
    (min_disp, num_disp - 1). Raises for another device, unequal shapes,
    more than MAX_DISP disparities or non-integer penalties."""
    k = lanes(num_disp)
    p1, p2 = _penalty("P1", p1), _penalty("P2", p2)
    bits = path_bits(p2)
    if left_gray.dim() != 2 or left_gray.shape != right_gray.shape:
        raise ValueError(f"grey pair {tuple(left_gray.shape)} and "
                         f"{tuple(right_gray.shape)}: want two equal [H, W]")
    h, w = left_gray.shape
    if 2 * h * w >= 2 ** 31:
        raise ValueError(f"{h}x{w}: the census indexes pixels in 32 bits")
    dev = left_gray.device
    if dev.type != "cuda" or right_gray.device != dev:
        raise ValueError(f"no SGM kernel for devices {dev} and "
                         f"{right_gray.device}")
    left = left_gray.float().contiguous()
    right = right_gray.float().contiguous()
    census = torch.empty((2, h, w), dtype=torch.int32, device=dev)
    paths = torch.empty(4 * h * w * 32 * k * bits // 8, dtype=torch.uint8,
                        device=dev)
    disp = torch.empty((h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with runtime.span("sgm.census"):
        _launch("census", left.data_ptr(), right.data_ptr(), h, w,
                census.data_ptr(), stream)
    with runtime.span("sgm.aggregate"):
        _launch("aggregate", census.data_ptr(), h, w, num_disp, k, p1, p2,
                bits, paths.data_ptr(), stream)
    with runtime.span("sgm.disparity"):
        _launch("winner", paths.data_ptr(), h, w, num_disp, k, bits,
                float(min_disp), disp.data_ptr(), stream)
    return disp


sgm.launches = 0


def _launch(kernel: str, *args) -> None:
    err = _fn(kernel)(*args)
    if err:
        raise RuntimeError(f"sgm {kernel} launch failed: error {err}")
    sgm.launches += 1


_ARGTYPES = dict(
    census=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p],
    aggregate=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p],
    winner=[ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p])


def _fn(kernel: str):
    from legslam_torch import _build
    return _build.function("sgm", f"legslam_sgm_{kernel}", _ARGTYPES[kernel])
