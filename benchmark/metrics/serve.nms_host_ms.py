"""Host time of the program's ``serve.nms`` span (the exact NMS and the
mask's output format, dispatched), mean over the traced window's calls,
ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.mean_ms("serve.nms")
