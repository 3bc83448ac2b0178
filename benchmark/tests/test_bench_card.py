"""On the card: a short run of every cell through ``benchmark/run.py`` comes
out correct with every metric it owes, and the fp8 control of each cell
fails one of its limits at the cell's own size.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import catalog

CELLS = [w["name"] for w in catalog.load_bench()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, name, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483999", "--seconds", "3", "--trace", str(trace)],
                         cwd=catalog.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    cell = catalog.find_cell(name)
    owed = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert result["correct"], result["checks"]
    assert owed <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == cell.chips


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = catalog.find_cell(name)
    session = cell.driver().Session(cell, 2147483998, card, lambda message: None)
    session.setup()
    session.window(2.0, False)
    session.release()
    control = session.judge(control=True)
    limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
    assert [k for k, v in limits.items() if not control[k] <= v], control
