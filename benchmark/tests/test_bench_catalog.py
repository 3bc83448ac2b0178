"""BENCHMARK.json against the benchmark's contract, and every name it holds
resolving to its file, also for a cell added as new files only."""

import hashlib
import json
import re

import pytest

from benchmark.harness import catalog
from benchmark.tests import small

BENCH = catalog.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert catalog.NAME.match(name), name
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert catalog.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS, m["name"]
        assert catalog.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert any(e["name"] == m["moves"] for e in BENCH["end_to_end"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = catalog.find_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.driver(), "Session")
    readers = cell.readers()
    assert readers and all(hasattr(r, "read") for r in readers.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell.per_layer:
        assert m["moves"] in reported
    assert cell.limits and cell.limits["numbers"], f"{name} has no limits file"


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.loads((catalog.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_cell_added_from_a_temporary_folder(tmp_path):
    root = small.checkout(tmp_path, limits={"mnv2-serve-small": {"mask_mean_abs": 1.0}})
    before = _digests(catalog.ROOT)
    after = _digests(root)
    changed = [k for k, v in before.items() if after.get(k) != v]
    assert not changed, changed
    cell = catalog.find_cell("mnv2-serve-small", root)
    assert cell.config["model"]["input_image_shape"] == [96, 128, 3]
    assert cell.mix["batch"] == 2 and cell.limits["numbers"]["mask_mean_abs"]["limit"] == 1.0
    assert {m["name"] for m in cell.per_layer} >= {"serve.launches", "mfu.serve"}
    assert re.match(r"^[a-z]", cell.driver().__name__)
