"""ctypes bindings for the native (C++) floor-map bank generators
(counterpart of apx.data.native).

Builds ``apx_torch/csrc/apx_native.cpp`` with ``g++ -O3 -pthread -shared
-fPIC -std=c++17`` on first use into ``apx_torch/_build/libapx_native.so``
(listed in ``.gitignore``), and again when the source is newer than the
library. Nothing is built at import. ``native_available()`` says whether
the library built and loaded; ``floor_map``'s ``backend="auto"`` uses it,
``backend="native"`` raises without it.

The native generators are deterministic per index but use their own pcg32
stream, not the reference's NumPy PCG64 chain: their maps are bitwise the
JAX package's native maps, and differ from the Python generators'.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "native_available",
    "generate_maze_bank_native",
    "generate_rooms_bank_native",
]

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "apx_native.cpp"
SO = _PKG / "_build" / "libapx_native.so"

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build() -> bool:
    # Compile to a private temp name, then rename atomically: concurrent
    # builders (pytest-xdist workers racing on first use) each publish a
    # complete library instead of interleaving writes into one path.
    SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-pthread", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, SO)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not SO.exists() or SRC.stat().st_mtime > SO.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(SO))
        except OSError:
            return None
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.apx_generate_maze_bank.argtypes = [
            u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.apx_generate_maze_bank.restype = None
        lib.apx_generate_rooms_bank.argtypes = [
            u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.apx_generate_rooms_bank.restype = None
        lib.apx_native_version.argtypes = []
        lib.apx_native_version.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _lib() is not None


def _need_lib() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native map generator unavailable: {SRC} did not build with g++")
    return lib


def _indices(indices) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(indices, dtype=np.uint64))


def generate_maze_bank_native(
    indices, width: int = 21, height: int = 21, branching_prob: float = 1.0
) -> np.ndarray:
    """(n, height, width) bool mazes, True = wall, one per index."""
    lib = _need_lib()
    idx = _indices(indices)
    out = np.empty((len(idx), height, width), dtype=np.uint8)
    lib.apx_generate_maze_bank(
        idx, len(idx), width, height, int(round(branching_prob * 1000)), out)
    return out.astype(bool)


def generate_rooms_bank_native(
    indices, width: int = 32, height: int = 32, max_rooms: int = 10, door_width: int = 3,
) -> np.ndarray:
    """(n, height, width) bool rooms maps, True = wall, one per index."""
    lib = _need_lib()
    idx = _indices(indices)
    out = np.empty((len(idx), height, width), dtype=np.uint8)
    lib.apx_generate_rooms_bank(idx, len(idx), width, height, max_rooms, door_width, out)
    return out.astype(bool)
