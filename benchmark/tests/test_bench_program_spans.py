"""The readers of the program's spans (`harness.program_spans` and the
metrics that use it) on a synthetic `Timeline` and synthetic program spans:
the pairing recovers the window's start, idle time goes to the innermost
span, every reader gives None where the spans do not pair; and a traced run
of each small cell on the CPU reports every metric that reads them."""

import json

import pytest

from benchmark.harness import catalog, cli, program_spans
from benchmark.harness.trace import Timeline
from benchmark.tests import small

BENCH = catalog.load_bench()
CELLS = {w["name"] for w in BENCH["workloads"]}
READERS = {
    "serve": ["serve.stage_ms", "serve.core_host_ms", "serve.nms_host_ms",
              "serve.idle_stage_ms", "serve.idle_dispatch_ms"],
    "train": ["loader.produce_ms", "loader.queue_depth", "train.stage_ms", "train.step_host_ms",
              "train.idle_loader_ms", "train.idle_stage_ms", "train.idle_dispatch_ms"],
}
NEW = READERS["serve"] + READERS["train"]
ORIGIN_NS = 1_792_000_000_123_456_789  # the window's start on the program's clock
MAIN, PRODUCER = 11, 22


def _ns(seconds: float) -> int:
    return ORIGIN_NS + round(seconds * 1e9)


def _timeline(ops, host, window_s):
    """A Timeline of ``ops`` (name, start s, end s) on the device and
    harness spans ``host`` (name, start s, end s) over ``window_s``."""
    timeline = Timeline(object(), (ORIGIN_NS, _ns(window_s)),
                        [(n, _ns(a), _ns(b)) for n, a, b in host])
    timeline.device_ops = sorted(ops, key=lambda t: t[1])
    timeline.busy = timeline._union()
    return timeline


def _record(name, index, parent, a, b, value=None, thread=MAIN):
    return (name, index, parent, thread, _ns(a), _ns(b), value)


def _serving():
    """Two calls, 0-4 s and 5-9 s (a harness ``serve.call`` each), each
    staged for 2 s, then 1.5 s in ``serve.core`` and 0.5 s in
    ``serve.nms``; the device works 0.0-1.0, 3.0-5.5 and 6.0-9.5 s; a
    request of an earlier session long before."""
    host = [("serve.call", 0.0, 4.0), ("serve.fetch", 4.0, 5.0), ("serve.call", 5.0, 9.0)]
    ops = [("k", 0.0, 1.0), ("k", 3.0, 5.5), ("k", 6.0, 9.5)]
    program = [_record("serve.request", 99, None, -10.0, -6.0)]
    for i, t in enumerate((0.0, 5.0)):
        program += [_record("serve.stage", i, "serve.request", t, t + 2.0),
                    _record("serve.core", i, "serve.request", t + 2.0, t + 3.5),
                    _record("serve.nms", i, "serve.request", t + 3.5, t + 4.0),
                    _record("serve.request", i, None, t, t + 4.0)]
    return {"timeline": _timeline(ops, host, 10.0), "units": 2}, program


@pytest.fixture
def read(monkeypatch):
    """``read(records, program)``: every reader's value on ``records`` with
    ``program`` as the program's recorded spans."""
    def run(records, program):
        monkeypatch.setattr(program_spans, "recorded", lambda: list(program))
        cell = catalog.find_cell("mnv2-serve-b128" if "serve.call" in {
            s[0] for s in records["timeline"].host_spans} else "mnv2-train-b32")
        return {name: reader.read(records) for name, reader in cell.readers().items()
                if name in NEW}
    return run


@pytest.mark.parametrize("shift", [0.0, 0.25, -3.0])
def test_the_pairing_recovers_the_windows_start(shift):
    records, program = _serving()
    # the program's stamps ``shift`` s off the harness's clock, and each
    # request 30 or 50 us after the harness's call began
    late = {0: 30_000, 1: 50_000, 99: 0}
    delta = round(shift * 1e9)
    program = [r[:4] + (r[4] + delta + late[r[1]], r[5] + delta + late[r[1]]) + r[6:]
               for r in program]
    placed = program_spans.place(records, program)
    assert placed is not None and placed.main == MAIN
    assert placed.origin_ns == ORIGIN_NS + delta + 40_000
    assert placed.spans["serve.stage"][0][:2] == pytest.approx((-10e-6, 2.0 - 10e-6), abs=1e-9)
    assert len(placed.spans["serve.request"]) == 2  # the earlier session's span is outside


def test_idle_goes_to_the_innermost_span(read):
    records, program = _serving()
    got = read(records, program)
    # idle: 1.0-3.0 (stage 1.0-2.0, core 2.0-3.0), 5.5-6.0 (stage), 9.5-10.0 (outside)
    assert got["serve.idle_stage_ms"] == pytest.approx(1e3 * (1.0 + 0.5) / 2)
    assert got["serve.idle_dispatch_ms"] == pytest.approx(1e3 * 1.0 / 2)
    assert got["serve.stage_ms"] == pytest.approx(2000.0)
    assert got["serve.core_host_ms"] == pytest.approx(1500.0)
    assert got["serve.nms_host_ms"] == pytest.approx(500.0)


def test_a_gap_inside_the_request_but_outside_its_steps_counts_for_neither():
    records, program = _serving()
    program = [r if r[0] != "serve.stage" else r[:5] + (r[5] - round(0.75e9),) + r[6:]
               for r in program]  # stages end 0.75 s earlier: 1.25-2.0 s is the request's own
    placed = program_spans.place(records, program)
    assert placed.idle_ms_per_unit(["serve.stage"]) == pytest.approx(1e3 * (0.25 + 0.5) / 2)
    assert placed.idle_ms_per_unit(["serve.core", "serve.nms"]) == pytest.approx(500.0)
    assert placed.idle_ms_per_unit(["serve.request"]) == pytest.approx(1e3 * 0.75 / 2)


def test_the_training_spans_and_the_producer_thread(read):
    host = [("train.fit", 0.0, 10.0), ("train.loader_wait", 0.5, 2.0)]
    ops = [("k", 2.5, 3.0), ("k", 4.0, 9.0)]
    program = [_record("train.epoch", 0, None, 0.0, 10.0),
               _record("loader.wait", 0, "train.epoch", 0.5, 2.0, value=0),
               _record("loader.wait", 1, "train.epoch", 3.0, 3.5, value=2),
               _record("train.stage", 0, "train.epoch", 2.0, 2.5),
               _record("train.step", 0, "train.epoch", 2.5, 3.0),
               _record("train.step", 1, "train.epoch", 3.5, 4.5),
               _record("loader.batch", 0, None, 0.2, 1.2, thread=PRODUCER),
               _record("loader.batch", 1, None, 1.2, 1.4, thread=PRODUCER)]
    got = read({"timeline": _timeline(ops, host, 10.0), "units": 2}, program)
    assert got["loader.produce_ms"] == pytest.approx(600.0)
    assert got["loader.queue_depth"] == pytest.approx(1.0)
    assert got["train.stage_ms"] == pytest.approx(250.0)
    assert got["train.step_host_ms"] == pytest.approx(750.0)
    # idle 0-2.5: 0-0.5 the epoch's own, 0.5-2.0 the wait, 2.0-2.5 staging;
    # 3.0-4.0: 3.0-3.5 the wait, 3.5-4.0 the step (the producer's thread is not the host's)
    assert got["train.idle_loader_ms"] == pytest.approx(1e3 * 2.0 / 2)
    assert got["train.idle_stage_ms"] == pytest.approx(1e3 * 0.5 / 2)
    assert got["train.idle_dispatch_ms"] == pytest.approx(1e3 * 0.5 / 2)


@pytest.mark.parametrize("program", ["none", "fewer"])
def test_every_reader_gives_none_when_the_spans_do_not_pair(read, program):
    records, spans = _serving()
    # "fewer": the window's first call alone, where the window holds two
    spans = [] if program == "none" else [r for r in spans if r[1] == 0]
    assert program_spans.place(records, spans) is None
    assert read(records, spans) == dict.fromkeys(READERS["serve"])


def test_each_new_metric_has_its_reader_unit_and_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for kind, names in READERS.items():
        for name in names:
            m = entries[name]
            assert catalog.UNIT.match(m["unit"]) and m["workloads"]
            assert set(m["workloads"]) <= CELLS
            assert all(kind in cell for cell in m["workloads"])
            assert (catalog.BENCH_DIR / "metrics" / f"{name}.py").is_file()
            assert m["source"] == ("device_trace" if ".idle_" in name else "program_span")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    limits = {name: {k: 1e9 for k in catalog.find_cell(like).limits["numbers"]}
              for name, (_, _, like) in small.CELLS.items()}
    return small.checkout(tmp_path_factory.mktemp("bench"), limits=limits)


@pytest.mark.parametrize("name", [small.name("mnv2-serve-b128"), small.name("mnv2-train-b32")])
def test_a_traced_run_reports_every_metric_that_reads_the_spans(root, name, monkeypatch):
    import torch.profiler

    # no card: the harness's profiler records the CPU's activity in its place
    cuda_only = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: cuda_only(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    lines = []
    result = cli.run(catalog.find_cell(name, root), 2147483999, 0.2, True, small.cpu(), 0.0,
                     out=lines.append)
    assert json.loads(lines[-1]) == result
    owed = READERS["serve" if "serve" in name else "train"]
    assert set(owed) <= set(result["metrics"]), sorted(result["metrics"])
    for metric in owed:
        assert result["metrics"][metric]["value"] >= 0
