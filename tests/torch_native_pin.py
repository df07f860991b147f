"""One private build of the JAX package's native tracking core per test
process, for the port's exact tracking comparisons.

legslam_tpu/slam/native.py builds native/libtracking_core.so in place:
every process compiles to the same object file, links straight onto the
path it loads and deletes the object in a `finally`. Test processes that
load it at the same moment (xdist workers) can delete each other's object
mid-build, so a fast-flag build fails and falls back, silently, to plain
-O3; or they load a half-written file. An -O3 build and the fast build
(-O3 -march=native -ffast-math -funroll-loops) find the same corners, but
their KLT tracks differ in the last bits, and the exact stream
comparisons see that.

So each process builds the JAX core once, with that module's own
`_build` and `load()`, from a copy of native/tracking_core.cpp in a
directory of its own, and checks that the build used the flags of the
port's library. The `jax_native_pin` fixture binds the JAX module to
that library for one test module and then restores the module's state
(`_SRC`, `_LIB`, `_TRIED`) for the JAX package's own tests. No file of
legslam_tpu changes: only these module globals are swapped.

Use: import `jax_native_pin` into the test module (pytest finds fixtures
by name in the module that uses them) and request it.
"""
import contextlib
import ctypes
import shutil
from pathlib import Path

import pytest

from legslam_tpu.slam import native as JN
from legslam_torch.slam import native as TN

JAX_SRC = Path(JN._SRC)
SHARED_LIB = JAX_SRC.parent / "libtracking_core.so"
FAST_FLAGS = tuple(JN._FAST_FLAGS)

# this process's private build: {"src": Path, "lib": CDLL}
_BUILT: dict = {}


def port_flags() -> tuple:
    """The flags of the tracking library the port loaded."""
    so = Path(TN.load()._name)
    for flags in (TN.FAST_FLAGS, TN.BASE_FLAGS):
        if so == TN._target(flags):
            return flags
    raise AssertionError(f"the port loaded {so}, the target of neither "
                         f"{TN.FAST_FLAGS} nor {TN.BASE_FLAGS}")


def recorded_flags(lib: ctypes.CDLL) -> list:
    """The flags the JAX module's `_build` recorded beside `lib`."""
    return Path(lib._name + ".flags").read_text().split()


@contextlib.contextmanager
def bound(src, lib):
    """The JAX module bound to `lib` (built from `src`) within."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_SRC", str(src))
        mp.setattr(JN, "_LIB", lib)
        mp.setattr(JN, "_TRIED", True)
        yield JN


def build_jax_core(directory, flags=None):
    """Build native/tracking_core.cpp in `directory` with the JAX module's
    own `_build` and `load()`, and return the loaded library (None when
    g++ fails). `flags` replaces both of the module's flag sets for the
    build, so that it uses those flags or fails. The module's state is
    restored afterwards."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    src = directory / JAX_SRC.name
    shutil.copyfile(JAX_SRC, src)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_SRC", str(src))
        mp.setattr(JN, "_LIB", None)
        mp.setattr(JN, "_TRIED", False)
        if flags is not None:
            mp.setattr(JN, "_FAST_FLAGS", list(flags))
            mp.setattr(JN, "_BASE_FLAGS", list(flags))
        return JN.load()


@pytest.fixture(scope="module")
def jax_native_pin(tmp_path_factory):
    """The JAX module bound, for the test module, to this process's private
    build of its core (built on first use), after checking that the build
    used the port's flags and that both trackers take the native route."""
    from legslam_tpu.slam import tracking as JT
    from legslam_torch.slam import tracking as TT
    if not _BUILT:
        d = tmp_path_factory.mktemp("jax_tracking_core")
        lib = build_jax_core(d)
        assert lib is not None, f"g++ failed to build the JAX core in {d}"
        _BUILT.update(src=d / JAX_SRC.name, lib=lib)
    lib = _BUILT["lib"]
    want, got = list(port_flags()), recorded_flags(lib)
    assert got == want, (
        f"the private JAX core was built with {got} and the port's with "
        f"{want}: their KLT tracks differ in the last bits")
    with bound(_BUILT["src"], lib):
        assert JN.load() is lib, "the JAX module is not bound to the " \
            "private build"
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LEGSLAM_NATIVE_TRACKING", "1")
            assert JT._use_native() and TT._use_native(), \
                "a tracker does not take the native route"
        yield JN
