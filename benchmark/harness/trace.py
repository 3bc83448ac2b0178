"""Spans from the harness's own files and the profiler's device timeline.

`Spans` times named host intervals (``perf_counter``) around the calls into
each layer and, while a profile is recorded, logs them on the profiler's
clock (``time.time_ns``) so that idle gaps on the device can be attributed
to what the main host thread was doing.  The profile records device
activity only (CUPTI): host operations are not traced, so the host runs at
its untraced pace.  `Timeline` reduces a
``torch.profiler`` trace to the records the per-layer readers take: every
device operation (kernel, copy, set) with its start and end, their union,
the idle gaps, and the marked host spans."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

class Spans:
    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.log: Optional[List[Tuple[str, int, int]]] = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1
        if self.log is not None:
            self.log.append((name, n0, time.time_ns()))

    def mean_ms(self, name: str) -> Optional[float]:
        return 1e3 * self.total[name] / self.count[name] if self.count.get(name) else None


def _events(prof) -> List:
    try:
        return list(prof.profiler.kineto_results.events())
    except AttributeError:  # an older profiler API
        return []


class Timeline:
    """Device operations and marked host spans of one profiled window, in
    seconds from the window's start."""

    def __init__(self, prof, window_ns: Tuple[int, int], host_log) -> None:
        start, end = window_ns
        self.window_s = (end - start) * 1e-9
        self.device_ops: List[Tuple[str, float, float]] = []
        self.host_spans: List[Tuple[str, float, float]] = []
        for e in _events(prof):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if b <= start or a >= end:
                continue
            a, b = (max(a, start) - start) * 1e-9, (min(b, end) - start) * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device_ops.append((e.name(), a, b))
        for name, a, b in host_log:
            if b > start and a < end:
                self.host_spans.append((name, (max(a, start) - start) * 1e-9,
                                        (min(b, end) - start) * 1e-9))
        self.device_ops.sort(key=lambda t: t[1])
        self.busy = self._union()

    def _union(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def by_name(self) -> Dict[str, float]:
        sums: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device_ops:
            sums[name] += b - a
        return dict(sums)

    def gaps(self) -> List[Tuple[float, float]]:
        edges, t = [], 0.0
        for a, b in self.busy:
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            edges.append((t, self.window_s))
        return edges

    def host_at(self, t: float) -> str:
        """The innermost marked host span around time ``t``."""
        best: Optional[Tuple[str, float, float]] = None
        for span in self.host_spans:
            if span[1] <= t <= span[2] and (best is None or span[2] - span[1] < best[2] - best[1]):
                best = span
        return best[0] if best else "outside the marked spans"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            idle[self.host_at((a + b) / 2)] += b - a
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def profiled(spans: Spans):
    """Profile device activity over the block; yields a dict that holds the
    Timeline once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, Timeline] = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    spans.log = []
    start = time.time_ns()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        end = time.time_ns()
        log, spans.log = spans.log, None
        prof.__exit__(None, None, None)
        out["timeline"] = Timeline(prof, (start, end), log)
