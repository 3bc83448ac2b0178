"""Host time of the program's ``train.stage`` spans (each chunk's pinned,
non-blocking upload) per training step, over the traced window, ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.per_unit_ms("train.stage")
