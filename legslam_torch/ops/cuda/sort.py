"""Radix sort kernels for binning: sort_keys, sort_kv and argsort_f32.

Counterpart of legslam_tpu/ops/pallas/sort.py. The kernel is an LSD radix
sort in CUDA C++ for sm_90a (legslam_torch/csrc/sort.cu, one C function
for every form): one histogram launch, then one launch per digit pass.
Each wrapper launches it for CUDA tensors, counted in `<fn>.launches` (one
per call), and runs its plain PyTorch version for CPU tensors. A failed
build or launch raises: nothing falls back to torch.sort on the card.

sort_kv orders (key, value) pairs lexicographically, so its output is
unique and, with iota values, that of a stable sort. The TPU network left
tied keys in no fixed order; a stable order is one of the orders it
permits, and it makes the kernel, its plain version and torch.sort agree
bit for bit. argsort_f32 runs only the key's digit passes, with the iota
made by the kernel: every pass is stable, so that is the same order.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1
# argsort_f32 pads to at least this length, as the TPU kernel did (two
# 128-lane rows)
MIN_ARGSORT_LENGTH = 256
# the kernel's status words count elements in 30 bits
MAX_LENGTH = 2 ** 30 - 1
# argsort_bits' keys (bit patterns of non-negative floats) are below 2^31
ARGSORT_KEY_BITS = 31


def padded_length(n: int, minimum: int = 1) -> int:
    """The least power of two >= max(n, minimum)."""
    return 1 << max(int(max(n, minimum)) - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def radix_plan(key_bits: int, with_values: bool = False
               ) -> tuple[int, int, int]:
    """(digit bits, key passes, value passes) of one sort of keys below
    2^key_bits: 8-bit digits, or 9-bit where that saves a pass; with
    values (the lexicographic order) the value's 32 bits first."""
    bits = 9 if -(-key_bits // 9) < -(-key_bits // 8) else 8
    return bits, -(-key_bits // bits), -(-32 // bits) if with_values else 0


def launches_per_call(key_bits: int, with_values: bool = False) -> int:
    """CUDA kernel launches of one sort: the histogram and one per pass."""
    _, kp, vp = radix_plan(key_bits, with_values)
    return 1 + kp + vp


def _check(keys: torch.Tensor, values: torch.Tensor | None = None,
           key_bits: int = 32):
    for name, x in (("keys", keys), ("values", values)):
        if x is None:
            continue
        if x.dtype != torch.int32 or x.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keys.shape[0] > MAX_LENGTH:
        raise ValueError(f"length {keys.shape[0]} exceeds {MAX_LENGTH}")
    if not 1 <= key_bits <= 32:
        raise ValueError(f"key_bits {key_bits} not in 1..32")
    if values is not None and (values.shape != keys.shape or
                               values.device != keys.device):
        raise ValueError("values must match keys in length and device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sort kernel for device {keys.device}")


def _launch(fn_obj, keys, values, key_bits, mode):
    """Run the kernel on CUDA tensors; returns (keys_out, values_out).
    mode "keys": keys alone; "kv": values carried, lexicographic order;
    "iota": the input positions carried, keys' passes only, sorted keys
    not written."""
    n = keys.shape[0]
    with_v = mode != "keys"
    out = torch.empty((2 if with_v else 1, n), dtype=torch.int32,
                      device=keys.device)
    if n > 0:
        bits, kp, vp = radix_plan(key_bits, mode == "kv")
        sort, scratch_words = _sort_fns()
        scratch = torch.empty(scratch_words(n, bits, kp + vp, int(with_v)),
                              dtype=torch.int32, device=keys.device)
        err = sort(keys.data_ptr(),
                   None if values is None else values.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), n, bits, kp,
                   -2 ** 31 if key_bits == 32 else 0, vp, int(with_v),
                   int(mode != "iota"),
                   torch.cuda.current_stream(keys.device).cuda_stream)
        if err:
            raise RuntimeError(f"sort kernel launch failed: error {err}")
        fn_obj.launches += 1
    return out[0], out[1] if with_v else None


def sort_keys(keys: torch.Tensor, key_bits: int = 32) -> torch.Tensor:
    """Ascending sort of int32 keys of any length. With key_bits < 32 the
    caller guarantees 0 <= key < 2^key_bits, and the kernel runs only the
    passes those bits need."""
    _check(keys, key_bits=key_bits)
    if keys.device.type == "cpu":
        return sort_keys_plain(keys)
    return _launch(sort_keys, keys, None, key_bits, "keys")[0]


sort_keys.launches = 0


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sort_keys."""
    return torch.sort(keys).values


def sort_kv(keys: torch.Tensor, values: torch.Tensor):
    """(key, value) pairs sorted ascending, lexicographically; int32 keys
    and values of one length. Returns (keys, values)."""
    _check(keys, values)
    if keys.device.type == "cpu":
        return sort_kv_plain(keys, values)
    return _launch(sort_kv, keys, values, 32, "kv")


sort_kv.launches = 0


def sort_kv_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version of sort_kv: a stable sort by value, then a
    stable sort by key, each with a gather (lexicographic order)."""
    by_value = torch.sort(values, stable=True).indices
    perm = by_value[torch.sort(keys[by_value], stable=True).indices]
    return keys[perm], values[perm]


def pad_keys(keys: torch.Tensor, minimum: int = 1) -> torch.Tensor:
    """int32 keys padded with INT32_MAX to padded_length(n, minimum)."""
    pad = padded_length(keys.shape[0], minimum) - keys.shape[0]
    return torch.cat([keys, torch.full((pad,), INT32_MAX, dtype=torch.int32,
                                       device=keys.device)])


def argsort_bits(keys: torch.Tensor, valid: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The int32 sort keys of argsort_f32: non-negative float keys as their
    bit patterns (order-isomorphic), invalid entries FLT_MAX, padded with
    INT32_MAX to a power of two >= 256."""
    k = keys.to(torch.float32)
    if valid is not None:
        k = torch.where(valid, k, float(np.finfo(np.float32).max))
    return pad_keys(k.contiguous().view(torch.int32), MIN_ARGSORT_LENGTH)


def argsort_order(bits: torch.Tensor) -> torch.Tensor:
    """The int32 stable ascending order of int32 keys in [0, 2^31): the
    values of sort_kv(bits, iota), counted as a sort_kv launch. The
    kernel makes the iota and runs only the key's passes."""
    _check(bits, key_bits=ARGSORT_KEY_BITS)
    if bits.device.type == "cpu":
        iota = torch.arange(bits.shape[0], dtype=torch.int32)
        return sort_kv_plain(bits, iota)[1]
    return _launch(sort_kv, bits, None, ARGSORT_KEY_BITS, "iota")[1]


def argsort_f32(keys: torch.Tensor, valid: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Ascending argsort of non-negative float keys (invalid and padded
    entries sink to the end, ties in index order). Returns the int32
    order of length padded_length(n, 256)."""
    return argsort_order(argsort_bits(keys, valid))


@functools.lru_cache(maxsize=None)
def _sort_fns():
    """(legslam_radix_sort, legslam_radix_scratch_words) of csrc/sort.cu."""
    from legslam_torch import _build
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return (_build.function("sort", "legslam_radix_sort",
                            [vp] * 4 + [ll, i, i, i, i, i, i, vp]),
            _build.function("sort", "legslam_radix_scratch_words",
                            [ll, i, i, i], restype=ll))
