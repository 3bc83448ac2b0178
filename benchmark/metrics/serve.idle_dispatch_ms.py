"""Device idle time per served batch while the host is innermost in the
program's ``serve.core`` or ``serve.nms`` span, over the traced window,
ms."""

from benchmark.harness import program_spans


def read(records):
    placed = program_spans.placed(records)
    return None if placed is None else placed.idle_ms_per_unit(["serve.core", "serve.nms"])
