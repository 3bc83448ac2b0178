"""Host time of the program's ``train.step`` span (the transform, the loss
and gradients and Adam, dispatched), mean over the traced window's steps,
ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.mean_ms("train.step")
