"""Batches waiting in the loader's prefetch queue when ``fit`` asks for the
next (the value of the program's ``loader.wait`` span), mean over the
traced window's waits, batches."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.mean_value("loader.wait")
