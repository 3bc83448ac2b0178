"""The program's own spans of a traced window on its `Timeline`'s clock, for
the per-layer readers that split the host's time and the device's idle time
by what the program was doing.

The program records a span (`ssdseglib_torch.utils.profiling.spans`:
name, index, parent, thread, start and end in ``time.time_ns()``, value)
only while a profiler records, so the spans of a traced run are those of
its traced window.  A `Timeline` keeps times in seconds from the window's
start but not the start itself, so the start is found on the program's
clock by pairing: the window's harness spans of one kind (``serve.call``,
``train.fit``) with as many of the program's last spans of the kind they
enclose (``serve.request``, ``train.epoch``), in order, the window's start
being the median difference of their starts.  Where the program recorded
fewer spans than that (a program without spans), `placed` gives None and
so does every reader.

Idle time: the timeline's gaps intersected with the spans of the program's
main thread (the thread of the paired spans), each idle interval counting
for the innermost span over it."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PAIRS = {"serve.call": "serve.request", "train.fit": "train.epoch"}


def recorded() -> List[tuple]:
    """The program's span records, or none where it has no recorder."""
    try:
        from ssdseglib_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


class Placed:
    """The program's spans of one traced window, in seconds from the
    window's start: ``spans[name]`` lists (start, end, value, thread)."""

    def __init__(self, program: Sequence[tuple], origin_ns: int, main: int, first: float,
                 last: float, timeline, units: int) -> None:
        self.timeline, self.units, self.main, self.origin_ns = timeline, units, main, origin_ns
        self.spans: Dict[str, List[Tuple[float, float, Optional[float], int]]] = defaultdict(list)
        for name, _, _, thread, a, b, value in program:
            a, b = (a - origin_ns) * 1e-9, (b - origin_ns) * 1e-9
            if a >= first and b <= last:
                self.spans[name].append((a, b, value, thread))

    def mean_ms(self, name: str) -> Optional[float]:
        got = self.spans.get(name)
        return 1e3 * sum(b - a for a, b, _, _ in got) / len(got) if got else None

    def per_unit_ms(self, name: str) -> Optional[float]:
        got = self.spans.get(name)
        if not got or not self.units:
            return None
        return 1e3 * sum(b - a for a, b, _, _ in got) / self.units

    def mean_value(self, name: str) -> Optional[float]:
        values = [v for _, _, v, _ in self.spans.get(name, ()) if v is not None]
        return sum(values) / len(values) if values else None

    def innermost(self) -> List[Tuple[float, float, str]]:
        """The main thread's time as disjoint (start, end, name) pieces, each
        named for the innermost span over it."""
        spans = [(a, b, name) for name, got in self.spans.items()
                 for a, b, _, thread in got if thread == self.main]
        edges = sorted({t for a, b, _ in spans for t in (a, b)})
        spans.sort()
        pieces, active, i = [], [], 0
        for lo, hi in zip(edges, edges[1:]):
            while i < len(spans) and spans[i][0] <= lo:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] > lo]
            if active:
                # nested on one thread: the latest to start is the innermost
                inner = max(active, key=lambda s: (s[0], -s[1]))
                pieces.append((lo, hi, inner[2]))
        return pieces

    def idle_ms_per_unit(self, names: Iterable[str]) -> Optional[float]:
        names = set(names)
        if not self.units or not any(self.spans.get(n) for n in names):
            return None
        return 1e3 * sum(_overlap(self.timeline.gaps(),
                                  [(a, b) for a, b, n in self.innermost() if n in names])) / self.units


def _overlap(xs: Sequence[Tuple[float, float]], ys: Sequence[Tuple[float, float]]) -> List[float]:
    """Lengths of the intersections of two sorted lists of disjoint
    intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            out.append(hi - lo)
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def place(records, program: Sequence[tuple]) -> Optional[Placed]:
    """``program``'s spans of the traced window whose records these are, or
    None where they do not pair with the window's harness spans."""
    timeline = records["timeline"]
    for outer, inner in PAIRS.items():
        harness = sorted(a for name, a, _ in timeline.host_spans if name == outer)
        if harness:
            break
    else:
        return None
    enclosing = sorted((r for r in program if r[0] == inner), key=lambda r: r[4])
    if len(enclosing) < len(harness):
        return None
    enclosing = enclosing[-len(harness):]
    diffs = sorted(r[4] - round(a * 1e9) for r, a in zip(enclosing, harness))
    origin_ns = (diffs[(len(diffs) - 1) // 2] + diffs[len(diffs) // 2]) // 2  # the median, in ns
    first = (enclosing[0][4] - origin_ns) * 1e-9
    last = (enclosing[-1][5] - origin_ns) * 1e-9
    return Placed(program, origin_ns, enclosing[0][3], first, last, timeline, records["units"])


def placed(records) -> Optional[Placed]:
    """`place` on the program's records, worked out once per run."""
    if "program_spans" not in records:
        records["program_spans"] = place(records, recorded())
    return records["program_spans"]
