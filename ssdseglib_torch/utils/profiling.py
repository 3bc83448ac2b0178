"""Timing and tracing on the card.

Counterpart of ``ssdseglib_tpu/utils/profiling.py``:

- `time_fn`: steady-state time of a call on the card, each call between two
  CUDA events after a warm-up, with percentiles; `time_jit_fn` is the JAX
  package's name for the same contract (it fences with
  ``block_until_ready``);
- `trace`: a context manager around ``torch.profiler`` that writes a trace
  directory (TensorBoard's profiler plugin or Perfetto read it) and hands
  back the profiler for ``key_averages()``;
- `span` / `spans`: the program's own host spans (serving call, `fit` loop,
  loader), recorded in memory while a ``torch.profiler`` session records and
  stamped with ``time.time_ns()``, the clock of the profiler's events.

A time is a device measurement: `time_fn` raises without a card rather than
time the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Timing:
    mean_s: float
    p50_s: float
    p95_s: float
    min_s: float
    steps: int
    device: str  # the card's name

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def time_fn(fn: Callable, args: Sequence[Any] = (), warmup: int = 3,
            steps: int = 20) -> Timing:
    """Per-call time of ``fn(*args)`` on the current card: ``warmup`` calls,
    then ``steps`` calls, each between two CUDA events on the current stream
    and waited for, so queued work of one call does not hide in the next."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn times work on a CUDA device; none is available")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    durations = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        durations.append(start.elapsed_time(end) / 1e3)
    d = np.asarray(durations)
    return Timing(
        mean_s=float(d.mean()),
        p50_s=float(np.percentile(d, 50)),
        p95_s=float(np.percentile(d, 95)),
        min_s=float(d.min()),
        steps=steps,
        device=torch.cuda.get_device_name(),
    )


def time_jit_fn(fn: Callable, args: Sequence[Any], warmup: int = 3,
                steps: int = 20) -> Timing:
    """`time_fn` under the JAX package's name and signature."""
    return time_fn(fn, args, warmup=warmup, steps=steps)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (host and, with a card,
    device activity) and write the trace into ``log_dir`` when it ends.  The
    program's spans of the block are read from `spans` afterwards: the
    records added since the block began."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    profiler.start()
    try:
        yield profiler
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()


class SpanRecord(NamedTuple):
    """One span: ``index`` identifies the request, step or batch it belongs
    to (shared by the spans of one request), ``parent`` is the name of the
    enclosing span on the same thread (None at the top), ``thread`` the
    recording thread's ``threading.get_ident()``, both times
    ``time.time_ns()``, ``value`` a number read when the span opened."""

    name: str
    index: Optional[int]
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int
    value: Optional[float]


_records: List[SpanRecord] = []
_local = threading.local()
_OFF = contextlib.nullcontext()
# process-wide: True on every thread while a torch.profiler session records
# (torch.autograd._profiler_enabled() is per thread and misses the loader's)
_profiler = torch.autograd.profiler


class _Span:
    __slots__ = ("name", "index", "value", "parent", "start_ns")

    def __init__(self, name: str, index: Optional[int], value: Optional[float]) -> None:
        self.name, self.index, self.value = name, index, value

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        _local.stack.pop()
        _records.append(SpanRecord(self.name, self.index, self.parent, threading.get_ident(),
                                   self.start_ns, end_ns, self.value))


def span(name: str, index: Optional[int] = None, value: Optional[float] = None):
    """A context manager that records the block as one `SpanRecord` while a
    ``torch.profiler`` session records, on any thread.  Otherwise it is one
    shared no-op context: no clock is read and nothing is allocated.  It
    adds no event to the profiler's own trace (no ``record_function``, no
    NVTX range), so the device timeline holds the same operations with the
    spans on."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, index, value)


def spans() -> List[SpanRecord]:
    """Every span recorded in this process so far, in the order they ended.
    Records are kept in memory only and only while a profiler records."""
    return list(_records)
