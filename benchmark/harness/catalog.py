"""Find what a cell names, by name: ``BENCHMARK.json`` at the root, the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
one reader ``metrics/<metric>.py`` per per-layer metric and the cell's
limits ``limits/<cell>.json``; the configuration's backbone is found by its
name in ``reference/backbones/`` and ``harness/backbones/``.  Adding a cell,
or a backbone, is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path``, loaded as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    def __init__(self, bench: Dict, workload: Dict, bench_dir: Path) -> None:
        self.bench_dir = bench_dir
        self.entry = workload
        self.name = workload["name"]
        self.chips = int(workload["chips"])
        config = next(c for c in bench["configs"] if c["name"] == workload["config"])
        self.config = json.loads((bench_dir.parent / config["file"]).read_text())
        self.mix = json.loads((bench_dir / "traffic" / f"{workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if self.name in m.get("workloads", self._reporting(m["moves"]))]
        limits = bench_dir / "limits" / f"{self.name}.json"
        self.limits: Optional[Dict] = json.loads(limits.read_text()) if limits.exists() else None

    def _reporting(self, moves: str) -> List[str]:
        return [self.name] if any(m["name"] == moves for m in self.end_to_end) else []

    def driver(self) -> ModuleType:
        name = self.mix["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py", f"bench_driver_{name}")

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                       "bench_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}


def load_bench(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    for workload in bench["workloads"]:
        if workload["name"] == name:
            return Cell(bench, workload, root / "benchmark")
    raise KeyError(f"no cell named {name!r} in {root / 'BENCHMARK.json'}")
