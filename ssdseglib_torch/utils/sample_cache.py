"""Cross-epoch decoded-sample cache (host RAM, bytes-bounded LRU); copy of
ssdseglib_tpu/utils/sample_cache.py, pure NumPy.

PNG/CSV decode is deterministic per file, but every consumer of the input
pipeline re-pays it each epoch: the reference's tf.data pipeline re-runs
`read_and_encode` per sample per epoch (reference datacoder.py:302-347,
notebook 03 cell 3 — tf.data has no `.cache()` in the recipe), and this
framework's `HostBatcher` re-decodes from disk likewise.  Only the
*augmentation* randomness (horizontal flip, color jitter) must stay live —
decode and anchor-encode are pure functions of the files.

This module is the shared memo: a thread-safe LRU keyed by the sample's
path triple plus each file's (st_mtime_ns, st_size), holding the decoded
fixed-shape arrays (image uint8, mask uint8 class map, padded ground
truth) and, optionally, the two flip-variant anchor encodings.  Epoch >= 2
then costs memcpys instead of zlib inflate + CSV parse + anchor matching.

Sized by SSDSEGLIB_SAMPLE_CACHE_MB (default 2048; 0 disables).  At the
reference dataset's 480x640 shapes an entry is ~1.2 MB (+0.3 MB with both
encodings), so the default holds ~1300 samples — the full synthetic
notebook workloads, and an LRU window of the real 3611-sample dataset.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

_DEFAULT_MB = 2048


def _nbytes(value) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    return 64  # scalars / small python objects


class SampleCache:
    """Thread-safe bytes-bounded LRU of immutable numpy payloads.

    Values are treated as immutable: callers must not mutate arrays they
    `get` (consumers copy when they need to flip in place).
    """

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        if max_bytes is None:
            max_bytes = int(
                os.environ.get("SSDSEGLIB_SAMPLE_CACHE_MB", str(_DEFAULT_MB))
            ) << 20
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: Dict[Any, Tuple[Any, int]] = {}
        self._order: Dict[Any, None] = {}  # insertion-ordered LRU
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def stat_key(self, *paths: str):
        """Key component binding each path to its current file identity;
        None (uncacheable) if any file is unstattable."""
        parts = []
        try:
            for p in paths:
                st = os.stat(p)
                parts.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            return None
        return tuple(parts)

    def get(self, key):
        if key is None or not self.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._order.pop(key, None)
            self._order[key] = None
            self.hits += 1
            return entry[0]

    def put(self, key, value) -> None:
        if key is None or not self.enabled:
            return
        nbytes = _nbytes(value)
        with self._lock:
            old = self._entries.pop(key, None)
            self._order.pop(key, None)
            if old is not None:
                self._total_bytes -= old[1]
            if nbytes > self.max_bytes:
                return  # single entry over the whole budget
            while self._total_bytes + nbytes > self.max_bytes and self._order:
                victim = next(iter(self._order))
                self._order.pop(victim)
                dropped = self._entries.pop(victim, None)
                if dropped is not None:
                    self._total_bytes -= dropped[1]
            self._entries[key] = (value, nbytes)
            self._order[key] = None
            self._total_bytes += nbytes

    def _bytes(self) -> int:
        return self._total_bytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self._total_bytes = 0
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_global: Optional[SampleCache] = None
_global_lock = threading.Lock()


def global_sample_cache() -> SampleCache:
    """Process-wide cache shared by every pipeline consumer (the compat
    `DataEncoderDecoder` and `HostBatcher` read the same files)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = SampleCache()
        return _global
