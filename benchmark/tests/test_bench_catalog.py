"""BENCHMARK.json against the benchmark's contract, and every name it holds
resolving to its file, also for a cell added as new files only."""

import hashlib
import json
import re
import subprocess
import sys
import textwrap

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


SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [{checkout!r}, {repo!r}]
    import torch
    torch.set_num_threads(2)
    from benchmark.harness import catalog, cli
    results = [cli.run(catalog.find_cell(name), 5, 0.2, False, torch.device("cpu"), 0.0,
                       out=lambda line: None) for name in {names!r}]
    print(json.dumps({{"root": str(catalog.ROOT), "results": results}}))
""")


def test_cell_added_from_a_temporary_folder(tmp_path):
    """A cell, and a backbone with its configuration, cell and limits, added
    as new files and entries; the copy of MobileNetV2 runs ``correct`` from
    the checkout alone and its judged numbers are the original's."""
    small_cell = small.name("mnv2-serve-b128")
    root = small.checkout(tmp_path, limits={small_cell: {"mask_mean_abs": 1.0}})
    copy, original = small.add_backbone_copy(root, "mnv2-serve-b128", "mobilenetv2_copy")
    before = _digests(catalog.ROOT)
    after = _digests(root)
    changed = [k for k, v in before.items() if after.get(k) != v]
    assert not changed, changed
    assert {"benchmark/reference/backbones/mobilenetv2_copy.py",
            "benchmark/harness/backbones/mobilenetv2_copy.py"} <= set(after) - set(before)
    cell = catalog.find_cell(small_cell, root)
    assert cell.config["model"]["input_image_shape"] == [96, 128, 3]
    assert cell.mix["batch"] == 2 and cell.limits["numbers"]["mask_mean_abs"]["limit"] == 1.0
    assert {m["name"] for m in cell.per_layer} >= {"serve.launches", "mfu.serve"}
    assert re.match(r"^[a-z]", cell.driver().__name__)
    assert catalog.find_cell(copy, root).config["model"]["backbone"] == "mobilenetv2_copy"

    # the copy's files are not in this checkout: run both cells from the temporary one
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        checkout=str(root), repo=str(catalog.ROOT), names=[copy, original])],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["root"] == str(root)
    ours, theirs = seen["results"]
    assert ours["correct"] and theirs["correct"], (ours["checks"], theirs["checks"])
    assert ours["checks"] == theirs["checks"]


def test_a_missing_backbone_names_the_file_it_looked_for():
    from benchmark.harness import program
    from benchmark.reference import model as ref_model

    with pytest.raises(FileNotFoundError, match=r"reference/backbones/no_such_net\.py"):
        ref_model.Network({"backbone": "no_such_net", "number_of_classes": 4})
    with pytest.raises(FileNotFoundError, match=r"harness/backbones/no_such_net\.py"):
        program.backbone("no_such_net")
