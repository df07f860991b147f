"""Bitonic sort kernels for binning: sort_keys, sort_kv and argsort_f32.

Counterpart of legslam_tpu/ops/pallas/sort.py. The kernels are CUDA C++
for sm_90a (legslam_torch/csrc/sort.cu, one C function for both forms);
each wrapper launches it for CUDA tensors, counted in `<fn>.launches` (one
per call), and runs its plain PyTorch version for CPU tensors. A failed build or
launch raises: nothing falls back to torch.sort on the card.

sort_kv orders (key, value) pairs lexicographically, so its output is
unique and, with iota values, that of a stable sort. The TPU network left
tied keys in no fixed order; a stable order is one of the orders it
permits, and it makes the kernel, its plain version and torch.sort agree
bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1
# argsort_f32 pads to at least this length, as the TPU kernel did (two
# 128-lane rows)
MIN_ARGSORT_LENGTH = 256


def is_power_of_two(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def padded_length(n: int, minimum: int = 1) -> int:
    """The least power of two >= max(n, minimum)."""
    return 1 << max(int(max(n, minimum)) - 1, 0).bit_length()


def _check(keys: torch.Tensor, values: torch.Tensor | None = None):
    for name, x in (("keys", keys), ("values", values)):
        if x is None:
            continue
        if x.dtype != torch.int32 or x.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not is_power_of_two(keys.shape[0]):
        raise ValueError(f"length {keys.shape[0]} is not a power of two")
    if values is not None and (values.shape != keys.shape or
                               values.device != keys.device):
        raise ValueError("values must match keys in length and device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sort kernel for device {keys.device}")


def _launch(fn_obj, keys, values):
    """Run the kernel on CUDA tensors; returns (keys_out, values_out)."""
    dev = keys.device
    out_k = torch.empty_like(keys)
    out_v = None if values is None else torch.empty_like(values)
    err = _sort_fn()(keys.data_ptr(),
                     None if values is None else values.data_ptr(),
                     out_k.data_ptr(),
                     None if out_v is None else out_v.data_ptr(),
                     keys.shape[0], int(values is not None),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sort kernel launch failed: error {err}")
    fn_obj.launches += 1
    return out_k, out_v


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of int32 keys; the length must be a power of two
    (callers pad with INT32_MAX)."""
    _check(keys)
    if keys.device.type == "cpu":
        return sort_keys_plain(keys)
    return _launch(sort_keys, keys, None)[0]


sort_keys.launches = 0


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sort_keys."""
    return torch.sort(keys).values


def sort_kv(keys: torch.Tensor, values: torch.Tensor):
    """(key, value) pairs sorted ascending, lexicographically; int32 keys
    and values of one power-of-two length. Returns (keys, values)."""
    _check(keys, values)
    if keys.device.type == "cpu":
        return sort_kv_plain(keys, values)
    return _launch(sort_kv, keys, values)


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


def argsort_f32(keys: torch.Tensor, valid: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Ascending argsort of non-negative float keys through sort_kv
    (invalid and padded entries sink to the end, ties in index order).
    Returns the int32 order of length padded_length(n, 256)."""
    bits = argsort_bits(keys, valid)
    iota = torch.arange(bits.shape[0], dtype=torch.int32, device=bits.device)
    return sort_kv(bits, iota)[1]


def _sort_fn():
    from legslam_torch import _build
    vp = ctypes.c_void_p
    return _build.function("sort", "legslam_sort",
                           [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                            vp])
