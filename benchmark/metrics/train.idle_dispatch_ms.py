"""Device idle time per training step while the host is innermost in the
program's ``train.step`` span, over the traced window, ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.idle_ms_per_unit(["train.step"])
