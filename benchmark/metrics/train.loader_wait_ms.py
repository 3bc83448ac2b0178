"""Time per step that ``fit`` waits in ``next()`` on the loader's raw
batches, over the untraced window, ms."""


def read(records):
    spans, steps = records["untraced_spans"], records.get("untraced_units")
    if not steps:
        return None
    return 1e3 * spans.total.get("train.loader_wait", 0.0) / steps
