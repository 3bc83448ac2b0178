"""Share of the traced training window in which no device operation ran, %."""


def read(records):
    t = records["timeline"]
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
