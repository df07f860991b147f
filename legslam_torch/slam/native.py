"""ctypes binding and on-demand g++ build of the native tracking kernels.

Counterpart of legslam_tpu/slam/native.py. The tracking frontend keeps its
orchestration in Python and runs the per-frame CV kernels (Shi-Tomasi
detection `st_detect`, pyramidal Lucas-Kanade `klt_track`) in C++, from the
port's own copy of the source, legslam_torch/csrc/tracking_core.cpp.

The library is built with g++ on first use into build/legslam_torch/ at
the repository root, keyed by a hash of the source and the flags, as
legslam_torch/_build.py keys the CUDA builds. The flags and the two-step
build are the JAX package's: compile with -O3 -march=native -ffast-math
-funroll-loops (else plain -O3 where the host rejects those), then link
without them. Linking with -ffast-math would pull in crtfastmath.o, whose
constructor sets the process-wide FTZ/DAZ bits when the library is loaded
and so changes torch's and numpy's handling of subnormals.

Unlike the JAX module, a failed build or load raises: the tracker's native
route never falls back to another detector or tracker.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "tracking_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "legslam_torch"
FAST_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops")
BASE_FLAGS = ("-O3",)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _target(flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"tracking_core-{h.hexdigest()[:16]}.so"


def _build(flags, out: Path) -> None:
    """Compile with `flags`, then link without them (see the module
    docstring); raises CalledProcessError with g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    obj = out.with_suffix(f".{os.getpid()}.o")
    try:
        subprocess.run(["g++", *flags, "-c", "-fPIC", "-std=c++17",
                        str(SRC), "-o", str(obj)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        subprocess.run(["g++", "-shared", str(obj), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)      # atomic against concurrent builds
    finally:
        obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)


def library_path() -> Path:
    """The built library, building it if needed: the fast flags, else the
    portable ones where g++ rejects them. Raises when neither builds."""
    fast, base = _target(FAST_FLAGS), _target(BASE_FLAGS)
    for so in (fast, base):
        if so.exists():
            return so
    errors = []
    for flags, so in ((FAST_FLAGS, fast), (BASE_FLAGS, base)):
        try:
            _build(flags, so)
            return so
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"g++ {' '.join(flags)}: "
                          f"{getattr(e, 'stderr', '') or e}")
    raise RuntimeError("building the native tracking kernels failed:\n" +
                       "\n".join(errors))


def load() -> ctypes.CDLL:
    """The loaded library, building it if needed. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(library_path()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.st_detect.restype = ctypes.c_int
        lib.st_detect.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, f32p]
        lib.klt_track.restype = None
        lib.klt_track.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                  f32p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, f32p, u8p]
        _LIB = lib
        return _LIB


def detect_corners(gray: np.ndarray, max_corners: int,
                   min_distance: int = 7,
                   quality: float = 0.01) -> np.ndarray:
    """[N,2] (x, y) Shi-Tomasi corners via the native kernel."""
    lib = load()
    g = np.ascontiguousarray(gray, np.float32)
    out = np.empty((max_corners, 2), np.float32)
    n = lib.st_detect(g, g.shape[0], g.shape[1], max_corners,
                      quality, min_distance, out)
    return out[:n].copy()


def klt_track(prev_gray: np.ndarray, cur_gray: np.ndarray,
              pts: np.ndarray, levels: int = 3, win: int = 10,
              iters: int = 30) -> tuple[np.ndarray, np.ndarray]:
    """Pyramidal LK: returns ([N,2] new points, [N] bool tracked)."""
    lib = load()
    p = np.ascontiguousarray(prev_gray, np.float32)
    c = np.ascontiguousarray(cur_gray, np.float32)
    q = np.ascontiguousarray(pts, np.float32)
    out = np.empty_like(q)
    status = np.empty(len(q), np.uint8)
    lib.klt_track(p, c, p.shape[0], p.shape[1], q, len(q), levels, win,
                  iters, out, status)
    return out, status.astype(bool)
