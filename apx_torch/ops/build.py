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
SOURCES = tuple(_PKG / "csrc" / f for f in (
    "raycast_slab.cu", "glimpse.cu", "window.cu", "issue_rate_study.cu", "numerics.cu",
    "lidar_step.cu", "merge.cu", "lidar_fused.cu", "capture.cu"))
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
    ptr = ctypes.c_void_p
    for name in ("raycast_fast_launch", "raycast_typed_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    for name in ("glimpse_f32_launch", "glimpse_u8_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, *[ctypes.c_int] * 6, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    lib.window_launch.argtypes = [ptr, ptr, ptr, *[ctypes.c_int] * 5, ptr]
    lib.window_launch.restype = ctypes.c_int
    lib.chain_launch.argtypes = [*[ptr] * 6, *[ctypes.c_int] * 4, ptr]
    lib.chain_launch.restype = ctypes.c_int
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fma_f32_launch.argtypes = [ptr, ptr, ptr, *[ctypes.c_float] * 3, ctypes.c_int, i64p,
                                   i64p, ptr, ptr]
    lib.sum_squares_f32_launch.argtypes = [ptr, ctypes.c_int, i64p, i64p, ctypes.c_int,
                                           ctypes.c_int64, ptr, ptr]
    lib.sqrt_f32_launch.argtypes = [ptr, ctypes.c_int, i64p, i64p, ptr, ptr]
    for fn in (lib.fma_f32_launch, lib.sum_squares_f32_launch, lib.sqrt_f32_launch):
        fn.restype = ctypes.c_int
    i32, f32 = ctypes.c_int, ctypes.c_float
    lib.lidar_step_a_launch.argtypes = [ptr, ptr, ptr, i32, i32, *[ptr] * 5, ptr]
    lib.lidar_step_b_launch.argtypes = [*[ptr] * 4, i32, *[ptr] * 6, ptr]
    lib.lidar_step_c_launch.argtypes = [*[ptr] * 13, i32, i32, *[ptr] * 7, ptr]
    lib.lidar_step_d_launch.argtypes = [ptr, ptr, ptr, f32, ptr, i32, i32, ptr, ptr, ptr]
    from . import merge_cuda

    lib.merge_next_step_launch.argtypes = [merge_cuda._Leaves, merge_cuda._Map,
                                           merge_cuda._Terms, ptr]
    lib.lidar_fused_step_launch.argtypes = [*[ptr] * 8, i32, f32, f32, i32, i32, i32,
                                            *[ptr] * 9, ptr]
    lib.lidar_fused_reset_launch.argtypes = [ptr, ptr, ptr, i32, f32, ptr, f32, i32, i32, i32,
                                             i32, *[ptr] * 5, ptr]
    i64out = ctypes.POINTER(ctypes.c_longlong)
    lib.apx_graph_device_nodes.argtypes = [ptr, i64out]
    lib.apx_capture_nodes.argtypes = [ptr, ctypes.POINTER(ctypes.c_ulonglong), i64out]
    for fn in (lib.lidar_step_a_launch, lib.lidar_step_b_launch, lib.lidar_step_c_launch,
               lib.lidar_step_d_launch, lib.merge_next_step_launch, lib.lidar_fused_step_launch,
               lib.lidar_fused_reset_launch, lib.apx_graph_device_nodes, lib.apx_capture_nodes):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def build_seconds() -> float | None:
    """Seconds ``load`` took in this process (building, or finding the
    library built), or None before the first load."""
    return _BUILD_SECONDS
