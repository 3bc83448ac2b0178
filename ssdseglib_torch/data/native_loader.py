"""ctypes bindings of the native C++ data-loader runtime (``native/``).

Counterpart of ``ssdseglib_tpu/data/native_loader.py``: PNG decode, CSV
parse, and whole-batch assembly in the C++ worker pool
(`ssdseg_loader_load_batch`).  The library is built from the repository's
``native/dataloader.cpp`` and ``native/decode_core.h``, with the flags of
``native/Makefile`` (g++, zlib), at first use, into
``ssdseglib_torch/build/native/`` (or the directory `utils.compile_cache`
names), never into ``native/``.  Its name carries a hash of the sources,
the flags and the host's CPU features (``-march=native`` code runs only on
a host like the one that built it), and it is written under a temporary
name and renamed into place, so processes that build it at once never load
half a file.

Callers catch `NativeLoaderError` and take the PIL path
(``data/pipeline.py::HostBatcher`` does so per batch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ssdseglib_torch.utils.compile_cache import build_directory, host_fingerprint

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = (NATIVE_DIR / "dataloader.cpp", NATIVE_DIR / "decode_core.h")
# native/Makefile's CXX, CXXFLAGS and LDFLAGS
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-lz", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NativeLoaderError(RuntimeError):
    """Failure reported by the C++ loader.  `code` is the native error code
    (dataloader.cpp's return conventions): -10..-22 PNG format /
    decode-capability limits, -30/-31 file IO, -40..-42 CSV parse, -50/-51
    image-shape mismatch, -60 native exception; None for a build or load
    failure."""

    def __init__(self, message: str, code: "int | None" = None) -> None:
        super().__init__(message)
        self.code = code

    @property
    def is_io_error(self) -> bool:
        """True for plain file-IO failures (missing or unreadable file),
        which another decoder cannot fix, unlike decode-capability limits
        (16-bit, interlaced, ...), where the PIL path is the right move."""
        return self.code in (-30, -31)


def library_path() -> Path:
    """Where the library for these sources, flags and this host lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join((CXX, *CXXFLAGS, *LDFLAGS, host_fingerprint())).encode())
    return build_directory() / "native" / f"libssdseg_native_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXXFLAGS, str(SOURCES[0]), "-o", str(tmp), *LDFLAGS]
    try:
        proc = subprocess.run(cmd, cwd=NATIVE_DIR, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeLoaderError(
                f"building the native loader failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)


def get_library() -> ctypes.CDLL:
    """The native library, built at first use, with its signatures set."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        target = library_path()
        try:
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except OSError as e:  # no compiler, or a library that does not load
            raise NativeLoaderError(f"the native loader is unavailable: {e}") from e

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ssdseg_png_info.argtypes = [u8p, ctypes.c_size_t, u32p, u32p, u32p]
        lib.ssdseg_png_info.restype = ctypes.c_int
        lib.ssdseg_png_decode_rgb.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.ssdseg_png_decode_rgb.restype = ctypes.c_int
        lib.ssdseg_png_decode_gray.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.ssdseg_png_decode_gray.restype = ctypes.c_int
        lib.ssdseg_csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, i32p, f32p, ctypes.c_int
        ]
        lib.ssdseg_csv_parse.restype = ctypes.c_int
        lib.ssdseg_loader_create.argtypes = [ctypes.c_int]
        lib.ssdseg_loader_create.restype = ctypes.c_void_p
        lib.ssdseg_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.ssdseg_loader_destroy.restype = None
        lib.ssdseg_loader_load_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            u8p, u8p, i32p, f32p, u8p, ctypes.c_int,
        ]
        lib.ssdseg_loader_load_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_info(data: bytes) -> Tuple[int, int, int]:
    """(height, width, channels) from a PNG's header."""
    lib = get_library()
    buf = np.frombuffer(data, dtype=np.uint8)
    w, h, c = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    ret = lib.ssdseg_png_info(
        _u8ptr(buf), len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)
    )
    if ret != 0:
        raise NativeLoaderError(f"png_info failed: {ret}", code=ret)
    return h.value, w.value, c.value


def decode_png_rgb(data: bytes) -> np.ndarray:
    """An 8-bit PNG as (H, W, 3) uint8 RGB (gray expanded, alpha dropped,
    palette looked up), as PIL's ``convert("RGB")``."""
    h, w, _ = png_info(data)
    out = np.empty((h, w, 3), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    ret = get_library().ssdseg_png_decode_rgb(_u8ptr(buf), len(data), _u8ptr(out))
    if ret != 0:
        raise NativeLoaderError(f"png_decode_rgb failed: {ret}", code=ret)
    return out


def decode_png_gray(data: bytes) -> np.ndarray:
    """An 8-bit PNG's first channel (or palette index) as (H, W) uint8."""
    h, w, _ = png_info(data)
    out = np.empty((h, w), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    ret = get_library().ssdseg_png_decode_gray(_u8ptr(buf), len(data), _u8ptr(out))
    if ret != 0:
        raise NativeLoaderError(f"png_decode_gray failed: {ret}", code=ret)
    return out


def parse_csv(text: bytes, max_rows: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(labels (R,) int32, boxes (R, 4) float32) from ground-truth CSV rows
    ``label,xmin,ymin,xmax,ymax``."""
    lib = get_library()
    labels = np.zeros((max_rows,), dtype=np.int32)
    boxes = np.zeros((max_rows, 4), dtype=np.float32)
    rows = lib.ssdseg_csv_parse(
        text, len(text),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
    )
    if rows < 0:
        raise NativeLoaderError(f"csv_parse failed: {rows}", code=rows)
    return labels[:rows].copy(), boxes[:rows].copy()


class NativeBatchLoader:
    """The C++ worker pool's batch assembler for on-disk datasets.

    `load_batch(triples)` decodes and pads a whole batch inside the native
    pool (ctypes releases the GIL for the call) and returns the arrays the
    Python path of `HostBatcher` gives.  `close` frees the pool.
    """

    def __init__(
        self,
        image_shape: Tuple[int, int],
        max_ground_truth_boxes: int = 32,
        num_workers: int = 8,
    ) -> None:
        self._lib = get_library()
        self._handle = self._lib.ssdseg_loader_create(num_workers)
        if not self._handle:
            raise NativeLoaderError("loader_create failed")
        self.image_shape = tuple(image_shape)
        self.max_gt = max_ground_truth_boxes

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ssdseg_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def load_batch(self, triples: Sequence[Tuple[str, str, str]]):
        """(images (B, H, W, 3) u8, masks (B, H, W) u8, labels (B, G) int32,
        boxes (B, G, 4) f32, valid (B, G) bool) of (image.png, mask.png,
        labels.csv) triples."""
        batch = len(triples)
        h, w = self.image_shape
        images = np.empty((batch, h, w, 3), dtype=np.uint8)
        masks = np.empty((batch, h, w), dtype=np.uint8)
        labels = np.zeros((batch, self.max_gt), dtype=np.int32)
        boxes = np.zeros((batch, self.max_gt, 4), dtype=np.float32)
        valid = np.zeros((batch, self.max_gt), dtype=np.uint8)

        def paths(idx):
            arr = (ctypes.c_char_p * batch)()
            for i, t in enumerate(triples):
                arr[i] = os.fsencode(t[idx])
            return arr

        img_paths, mask_paths, csv_paths = paths(0), paths(1), paths(2)
        ret = self._lib.ssdseg_loader_load_batch(
            self._handle, img_paths, mask_paths, csv_paths,
            batch, h, w,
            _u8ptr(images), _u8ptr(masks),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _u8ptr(valid), self.max_gt,
        )
        if ret != 0:
            raise NativeLoaderError(f"load_batch failed: {ret}", code=ret)
        return images, masks, labels, boxes, valid.astype(bool)


def available() -> bool:
    """Whether the native library builds and loads here (`get_library`)."""
    try:
        get_library()
        return True
    except NativeLoaderError:
        return False
