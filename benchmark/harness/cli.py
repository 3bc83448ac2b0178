"""One run of one cell: set-up, the measured window, the per-layer readers
(``--trace 1``), the check of the outputs against the plain reference, and
the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exit codes: 0 with a result line; 2 for bad arguments; 3 without the card(s)
the cell needs; 4 when a forbidden module (JAX or the JAX package) is loaded
after the window.  Every exit but 0 prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ssdseglib_tpu", "ssdseglib")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole (so
    ``ssdseglib_torch`` is not ``ssdseglib``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def check(numbers: Dict[str, float], limits: Optional[Dict]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit."""
    if not limits:
        return {}
    return {name: {"value": numbers[name], "limit": spec["limit"]}
            for name, spec in limits["numbers"].items()}


def run(cell, seed: int, seconds: float, trace: bool, device, started: float,
        fault: Optional[str] = None, out: Callable[[str], None] = print) -> Dict:
    """Run ``cell`` once on ``device`` and return the result object (also
    printed by ``out``: the comparisons on standard error, the result line
    last)."""
    import torch

    log(f"[bench] cell {cell.name} seed {seed} seconds {seconds} trace {int(trace)} "
        f"on {device}: {card_line() if device.type == 'cuda' else 'cpu'}")
    import_s = time.perf_counter() - started
    session = cell.driver().Session(cell, seed, device, log, fault=fault)
    session.setup()
    setup_s = time.perf_counter() - started
    log("[bench] set-up split (s): " + json.dumps({"import": import_s, **session.split,
                                                   "total": setup_s}))
    measured = session.window(seconds, trace)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    work = session.work()

    metrics: Dict[str, Dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        records = {**measured["trace"], "untraced_spans": measured["spans"],
                   "untraced_units": measured["attempted"],
                   "untraced_images_per_s": measured["images_per_s"], "work": work,
                   "config": cell.config, "mix": cell.mix}
        timeline = records["timeline"]
        for name, reader in cell.readers().items():
            value = reader.read(records)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device_info.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        breakdown = timeline.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": measured["metrics"][m["name"]], "unit": m["unit"]}

    session.release()
    numbers = session.judge()
    compared = check(numbers, cell.limits)
    correct = bool(compared) and all(c["value"] <= c["limit"] for c in compared.values())
    correct = correct and measured["failed"] == 0 and all(
        math.isfinite(v["value"]) for v in metrics.values())
    log("[bench] judged: " + json.dumps(numbers))
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    result = {"correct": correct, "attempted": measured["attempted"], "failed": measured["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    if not compared:
        log("[bench] no limits for this cell: correct is false")
    for name, c in compared.items():
        log(f"[bench] check {name}: {c['value']!r} against the limit {c['limit']!r} "
            f"({'ok' if c['value'] <= c['limit'] else 'FAILED'})")
    out(json.dumps(result))
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv, started: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.harness.catalog import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[bench] the cell needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    try:
        run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), started)
    except ForbiddenModules as e:
        log(f"[bench] forbidden modules loaded: {', '.join(e.args[0])}")
        return 4
    return 0
