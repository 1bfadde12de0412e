"""Builds and loads the port's CUDA kernels on first use.

``torch.utils.cpp_extension.load`` compiles ``apx_torch/csrc/*.cu`` (and
the device code they share, ``csrc/*.cuh``) with nvcc for ``sm_90a`` into
``apx_torch/_build/`` (listed in ``.gitignore``) and rebuilds when a source,
a header or a flag changes. The sources include no PyTorch header and
export a plain C interface (``is_python_module=False``), so a build takes
seconds, and ``ctypes`` binds the functions.

Nothing is built at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import time
from pathlib import Path

__all__ = ["load", "SOURCES", "NVCC_FLAGS", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
# These flags are what make the kernels bitwise equal to their plain forms.
# -fmad=false: no contraction of a*b+c (the kernels write each FMA they
# want as __fmaf_rn, and numerics.cu's x0 * x0 stays a rounded product);
# -prec-div=true, -prec-sqrt=true: IEEE division and correctly rounded
# square root (numerics.cu's N3); -ftz=false: subnormals kept, as the
# plain forms' float64 emulation keeps them.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-fmad=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-ftz=false",
)

_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None


def _headers_flag() -> str:
    """A define holding a digest of the shared headers: ``load`` versions a
    build by its sources and flags only, so a changed header changes a
    flag."""
    digest = hashlib.sha1(b"".join(h.read_bytes() for h in HEADERS)).hexdigest()[:16]
    return f"-DAPX_CSRC_HEADERS=0x{digest}"


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use. ``verbose`` prints the
    build's output, ptxas' register and spill report included."""
    global _LIB, _BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    from torch.utils.cpp_extension import load as cpp_load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = cpp_load(
        name="apx_kernels",
        sources=[str(s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=[*NVCC_FLAGS, _headers_flag(), *(["-Xptxas=-v"] if verbose else [])],
        is_python_module=False,
        verbose=verbose,
    )
    _BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    # The library's two entries that launch no kernel (capture.cu, read by
    # core.trace); the kernels' entries are declared by their wrappers
    # (ops._launch.entry).
    ptr, nodes = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    lib.apx_graph_device_nodes.argtypes = [ptr, nodes]
    lib.apx_capture_nodes.argtypes = [ptr, ctypes.POINTER(ctypes.c_ulonglong), nodes]
    lib.apx_graph_device_nodes.restype = lib.apx_capture_nodes.restype = ctypes.c_int
    _LIB = lib
    return lib


def build_seconds() -> float | None:
    """Seconds ``load`` took in this process (building, or finding the
    library built), or None before the first load."""
    return _BUILD_SECONDS
