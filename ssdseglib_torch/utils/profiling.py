"""Timing and tracing on the card.

Counterpart of ``ssdseglib_tpu/utils/profiling.py``:

- `time_fn`: steady-state time of a call on the card, each call between two
  CUDA events after a warm-up, with percentiles; `time_jit_fn` is the JAX
  package's name for the same contract (it fences with
  ``block_until_ready``);
- `trace`: a context manager around ``torch.profiler`` that writes a trace
  directory (TensorBoard's profiler plugin or Perfetto read it) and hands
  back the profiler for ``key_averages()``.

A time is a device measurement: `time_fn` raises without a card rather than
time the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Sequence

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
    device activity) and write the trace into ``log_dir`` when it ends."""
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
