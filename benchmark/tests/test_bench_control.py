"""The comparison that decides ``correct`` has to fail: the control (the
plain reference computed in fp8, in the program's place) and each planted
fault of a cell, driven through the rest of a run with the look for a card
skipped, at 96 x 128 on the CPU under the cell's own limits."""

import json

import pytest

from benchmark.harness import catalog, cli
from benchmark.tests import small

SMALL = {name: like for name, (_, _, like) in small.CELLS.items()}


def _limits():
    return {name: {k: v["limit"] for k, v in catalog.find_cell(like).limits["numbers"].items()}
            for name, like in SMALL.items()}


def _failed(numbers, limits):
    return [k for k, limit in limits.items() if not numbers[k] <= limit]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.checkout(tmp_path_factory.mktemp("bench"), limits=_limits())


def _run(root, name, fault=None, seed=3):
    lines = []
    result = cli.run(catalog.find_cell(name, root), seed, 0.2, False, small.cpu(), 0.0,
                     fault=fault, out=lines.append)
    assert json.loads(lines[-1]) == result
    return result


@pytest.mark.parametrize("name", list(SMALL))
def test_a_sound_run_is_correct(root, name):
    result = _run(root, name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in SMALL for f in catalog.find_cell(
    SMALL[n]).driver().FAULTS])
def test_each_planted_fault_is_not_correct(root, name, fault):
    result = _run(root, name, fault)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("name", list(SMALL))
def test_the_control_fails_a_limit(root, name):
    cell = catalog.find_cell(name, root)
    session = cell.driver().Session(cell, 4, small.cpu(), cli.log)
    session.setup()
    session.window(0.2, False)
    session.release()
    control = session.judge(control=True)
    assert _failed(control, _limits()[name]), control


def test_a_state_left_unchanged_reads_one():
    """A training step that returns its state unchanged reads 1 on the
    change of the parameters, with no run."""
    import torch

    compare = catalog.find_cell("mnv2-train-b32").driver().compare_steps
    gen = torch.Generator().manual_seed(0)
    p0 = {f"leaf{i}": torch.randn(8, generator=gen) for i in range(5)}
    grads = {k: torch.randn(8, generator=gen) for k in p0}
    moved = {k: v - 1e-4 * torch.sign(grads[k]) for k, v in p0.items()}
    numbers = compare([2.0], grads, p0, [2.0], grads, moved, p0)
    assert numbers["change_gap"] == pytest.approx(1.0)
    assert numbers["loss1_gap"] == 0.0 and numbers["grad_gap"] == 0.0
