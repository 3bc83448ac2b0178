"""Time the loader's producer thread takes to assemble one batch (the
program's ``loader.batch`` span), mean over the traced window, ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.mean_ms("loader.batch")
