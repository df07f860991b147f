"""Runtime helpers: timing, profiling and device-memory statistics.

Counterpart of legslam_tpu/utils/runtime.py. Two of its functions have no
meaning under PyTorch and are not defined here: `enable_compilation_cache`
(PyTorch runs eagerly; the CUDA kernels are built once into
build/legslam_torch/ by legslam_torch._build) and `force_cpu` (the port
picks a device per call: every entry point takes `device=`).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def timed(label: str, sink: list | None = None):
    """Host-clock seconds of the block, appended to `sink` as (label, s).
    Device work is asynchronous: end the block with a synchronise to time
    it."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))


@contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present), written as a Chrome trace to <log_dir>/trace.json (view in
    Perfetto or chrome://tracing): the reference's chrono probes
    (SURVEY.md §5)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    """{device name: {bytes_in_use, peak_bytes_in_use, bytes_reserved}}
    of every CUDA device, from PyTorch's caching allocator (the c10
    CUDACachingAllocator statistics of examples/replica_rgbd.cpp:280-294);
    empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i} {torch.cuda.get_device_name(i)}"] = dict(
            bytes_in_use=torch.cuda.memory_allocated(i),
            peak_bytes_in_use=torch.cuda.max_memory_allocated(i),
            bytes_reserved=torch.cuda.memory_reserved(i))
    return out


def save_peak_memory(path: str, device: torch.device) -> None:
    """The reference's GpuPeakUsageMB.txt (examples/replica_rgbd.cpp:
    280-294): one 'device peak_mb in_use_mb' line from PyTorch's caching
    allocator."""
    with open(path, "w") as f:
        if device.type != "cuda":
            f.write(f"{device} peak_mb=not measured\n")
            return
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
        cur = torch.cuda.memory_allocated(device) / 2 ** 20
        f.write(f"{torch.cuda.get_device_name(device)} peak_mb={peak:.1f} "
                f"in_use_mb={cur:.1f}\n")
