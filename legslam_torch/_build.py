"""Build the port's CUDA kernels and load them with ctypes.

Each source legslam_torch/csrc/<name>.cu has a plain C interface and no
PyTorch headers, so nvcc builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

The libraries go to build/legslam_torch/ at the repository root, keyed by
a hash of the sources, headers and flags, and are built on first use
(build() compiles several at once, one nvcc per source). Only the sources
in the repository are built; a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "legslam_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build legslam_torch's kernels")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (ptxas registers, shared memory, spills) of a build."""
    return _target(name).with_suffix(".log")


def build(names) -> dict[str, float]:
    """Build the named sources that are not built yet, one nvcc process
    each, all started together. Returns {name: seconds} of the builds run."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        src = CSRC / f"{n}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        log_path(n).write_text(out)
        os.replace(tmp, _target(n))    # atomic against concurrent builds
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function `symbol` of source `name`, building it if needed.
    The kernels' functions return a cudaError_t (0 = success) as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn
