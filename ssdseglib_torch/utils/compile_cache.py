"""Where the port's compiled code lives: the nvcc kernel library
(``ops/_cuda_build.py``) and the native data loader (``data/native_loader.py``).

Counterpart of ``ssdseglib_tpu/utils/compile_cache.py``, whose persistent
cache keeps XLA executables across processes.  The port has no XLA
programs; what a fresh process would compile again is the two shared
libraries, each named by a hash of its sources and flags, so a directory
that outlives the process is a cache of them.  By default they are built
into ``ssdseglib_torch/build/`` (ignored by git); `enable_compile_cache`
points both builds at another directory:

    from ssdseglib_torch.utils.compile_cache import enable_compile_cache
    enable_compile_cache()             # ssdseglib_torch/build/cache/host-<isa>
    enable_compile_cache("/fast/dir")  # exactly that directory

The default location is scoped to the host's CPU features
(``host-<fingerprint>``): the native loader is compiled with
``-march=native`` and may not run on a host with fewer features.  Call it
before the first kernel or loader is built: a library already loaded in the
process stays loaded.
"""

from __future__ import annotations

import hashlib
import os
import platform
from pathlib import Path
from typing import Optional

_PACKAGE_BUILD = Path(__file__).resolve().parents[1] / "build"
_cache_dir: Optional[Path] = None


def host_fingerprint() -> str:
    """Short stable id of the host CPU's feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    if not flags:
        flags = f"{platform.machine()}|{platform.processor()}"
    return hashlib.sha1(flags.encode()).hexdigest()[:12]


def build_directory() -> Path:
    """The directory the kernel library and the native loader are built
    into: the one `enable_compile_cache` set, else ``ssdseglib_torch/build``."""
    return _cache_dir if _cache_dir is not None else _PACKAGE_BUILD


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Build the kernel library and the native loader into ``cache_dir``
    (used as it is) and reuse what is there; with no argument, into
    ``ssdseglib_torch/build/cache/host-<fingerprint>``.  Returns the
    directory."""
    global _cache_dir
    if cache_dir is None:
        cache_dir = str(_PACKAGE_BUILD / "cache" / f"host-{host_fingerprint()}")
    os.makedirs(cache_dir, exist_ok=True)
    _cache_dir = Path(cache_dir)
    return cache_dir
