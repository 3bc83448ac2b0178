"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into ``ssdseglib_torch/build/`` (listed
in ``.gitignore``), named by a hash of the sources and flags, so a fresh
checkout builds it once and an edited source builds anew.  Nothing here
runs at import time.
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

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "fused_mbconv.cu",)
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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
            "fused MBConv kernel is built from source at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> BuildInfo:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return BuildInfo(target, seconds, proc.stderr)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"libssdseg_kernels_{_digest()}.so"
    build_info = _build(target) if not target.exists() else BuildInfo(target, 0.0, "")
    lib = ctypes.CDLL(str(target))
    ptr = ctypes.c_void_p
    lib.fused_mbconv_launch.argtypes = (
        [ctypes.c_int] + [ptr] * 8 + [ctypes.c_int] * 7 + [ptr]
    )
    lib.fused_mbconv_launch.restype = ctypes.c_int
    lib.fused_mbconv_tile.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)
    ] * 2
    lib.fused_mbconv_tile.restype = ctypes.c_int
    _lib = lib
    return lib
