"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into ``ssdseglib_torch/build/`` (listed
in ``.gitignore``) or the directory `utils.compile_cache.enable_compile_cache`
names, under a hash of the sources and flags, so a fresh checkout builds it
once and an edited source builds anew.  Every source is
compiled by an nvcc of its own, all started together, and the objects are
linked into one library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from ssdseglib_torch.utils.compile_cache import build_directory

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
SOURCES = (
    _CSRC / "fused_mbconv.cu",
    _CSRC / "depthwise_backward.cu",
    _CSRC / "fused_chain_backward.cu",
    _CSRC / "nms_scan.cu",
    _CSRC / "s2d_stem.cu",
    _CSRC / "pointwise_wgrad.cu",
    _CSRC / "int8_pointwise.cu",
    _CSRC / "depthwise3x3.cu",
)
HEADERS = (_CSRC / "common.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo:
    """What the last build or load did: the library path, the seconds the
    build took (0.0 when a built library was reused) and ptxas's report."""

    def __init__(self, path: Path, seconds: float, ptxas: str) -> None:
        self.path = path
        self.seconds = seconds
        self.ptxas = ptxas


_lib: Optional[ctypes.CDLL] = None
build_info: Optional[BuildInfo] = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "kernel library (ssdseglib_torch/csrc/*.cu) is built from source "
            "at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> BuildInfo:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    objects = [target.parent / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = target.parent / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        compiles = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(SOURCES, objects))
        ]
        # wait for every compiler before raising, so none is left running
        results = [(cmd, proc.communicate(), proc.returncode)
                   for cmd, proc in compiles]
        link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objects)]
        ptxas = ""
        for cmd, (_, stderr), returncode in results:
            if returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}"
                )
            ptxas += stderr
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return BuildInfo(target, time.perf_counter() - t0, ptxas)


def library_path() -> Path:
    """Where the library for these sources and flags lives."""
    return build_directory() / f"libssdseg_kernels_{_digest()}.so"


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    target = library_path()
    build_info = _build(target) if not target.exists() else BuildInfo(target, 0.0, "")
    lib = ctypes.CDLL(str(target))
    ptr = ctypes.c_void_p
    # (dtype, x, w1, b1, wd, b2, w3, b3, out, B, H, W, Cin, E, Cout, residual,
    #  th, tw, ec, nrep, stream)
    lib.fused_mbconv_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 8 + [ctypes.c_int] * 11 + [ptr]
    )
    lib.fused_mbconv_launch.restype = ctypes.c_int
    # (dtype, Cin, E, Cout, *th, *tw, *ec, *threads, *smem)
    lib.fused_mbconv_tile.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)
    ] * 5
    lib.fused_mbconv_tile.restype = ctypes.c_int
    # (dtype, B, H, W, C, tr, tw, chunk, *floats, *counters, *geometry[5])
    lib.depthwise_backward_scratch.argtypes = [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int), ptr]
    lib.depthwise_backward_scratch.restype = ctypes.c_int
    # (dtype, x, dy, k, k_bf16, kts, kcs, dx, dk, scratch, counters, B, H, W, C,
    #  tr, tw, chunk, ctas, stream)
    lib.depthwise_backward_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 3 + [ctypes.c_int] * 3 + [ptr] * 4 + [ctypes.c_int] * 8
        + [ptr]
    )
    lib.depthwise_backward_launch.restype = ctypes.c_int
    # (dtype, B, H, W, C, tr, tw, *floats, *counters)
    lib.chain_backward_scratch.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.chain_backward_scratch.restype = ctypes.c_int
    # (dtype, x, u, dy, k, k_bf16, kts, kcs, mean, inv, A, beta, dx, dk, sums,
    #  scratch, counters, B, H, W, C, tr, tw, stream)
    lib.chain_backward_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 4 + [ctypes.c_int] * 3 + [ptr] * 9 + [ctypes.c_int] * 6
        + [ptr]
    )
    lib.chain_backward_launch.restype = ctypes.c_int
    # the split path: (dtype, u, dy, mean, inv, A, beta, sums, scratch,
    # counters, B, H, W, C, stream), then (dtype, x, u, dy, k, k_bf16, kts,
    # kcs, mean, inv, A, beta, global sums, n_total, dx, dk, scratch,
    # counters, B, H, W, C, tr, tw, du's rows lo, hi, stream)
    lib.chain_backward_sums.argtypes = [ctypes.c_int] + [ptr] * 9 + [ctypes.c_int] * 4 + [ptr]
    lib.chain_backward_sums.restype = ctypes.c_int
    lib.chain_backward_apply.argtypes = (
        [ctypes.c_int] + [ptr] * 4 + [ctypes.c_int] * 3 + [ptr] * 5 + [ctypes.c_longlong]
        + [ptr] * 4 + [ctypes.c_int] * 8 + [ptr]
    )
    lib.chain_backward_apply.restype = ctypes.c_int
    # (iou, valid, threshold, keep, rows, K, max_keep, stream)
    lib.nms_scan_launch.argtypes = [ptr] * 4 + [ctypes.c_int] * 3 + [ptr]
    lib.nms_scan_launch.restype = ctypes.c_int
    # (dtype, images, six (weight, bias) pairs, out, B, H, W, to, tw, ec, warps,
    #  stream)
    lib.stem_block1_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 14 + [ctypes.c_int] * 7 + [ptr]
    )
    lib.stem_block1_launch.restype = ctypes.c_int
    # (H, W, *to, *tw, *ec, *warps, *smem)
    lib.stem_block1_config.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)
    ] * 5
    lib.stem_block1_config.restype = ctypes.c_int
    # (kernel, K, Ci, Co, rows, ctas, *ctas_out, *counters_out)
    lib.pointwise_wgrad_grid.argtypes = (
        [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int)] * 2
    )
    lib.pointwise_wgrad_grid.restype = ctypes.c_int
    # (dtype, Ci, Co, rows, stages, block, *out[5])
    lib.wgrad_fma_config.argtypes = [ctypes.c_int] * 6 + [ptr]
    lib.wgrad_fma_config.restype = ctypes.c_int
    # (dtype, x, dy, partials, counters, out, out_bf16, K, Ci, Co, rows, ctas,
    #  stages, block, stream)
    lib.wgrad_fma_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ptr]
    )
    lib.wgrad_fma_launch.restype = ctypes.c_int
    # (kernel, dtype, x, dy, partials, counters, out, out_bf16, K, Ci, Co, rows,
    #  ctas, stream)
    lib.pointwise_wgrad_launch.argtypes = (
        [ctypes.c_int] * 2 + [ptr] * 5 + [ctypes.c_int] + [ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ptr]
    )
    lib.pointwise_wgrad_launch.restype = ctypes.c_int
    # (dtype, x, wq, inv_x_scale, dequant, bias, y, xq or null, rows, Ci, Co,
    #  stream)
    lib.int8_pointwise_launch.argtypes = [ctypes.c_int] + [ptr] * 7 + [ctypes.c_int] * 3 + [ptr]
    lib.int8_pointwise_launch.restype = ctypes.c_int
    # (dtype, rows, Ci, Co, *out[11])
    lib.int8_pointwise_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.int8_pointwise_plan.restype = ctypes.c_int
    # (x, k, kcs, kis, kjs, bias or null, y, B, H, W, C, Ho, Wo, stride,
    #  dilation, pad_top, pad_left, act, cap, stream)
    lib.depthwise3x3_launch.argtypes = (
        [ptr, ptr] + [ctypes.c_int] * 3 + [ptr, ptr] + [ctypes.c_int] * 11 + [ctypes.c_float, ptr]
    )
    lib.depthwise3x3_launch.restype = ctypes.c_int
    _lib = lib
    return lib
