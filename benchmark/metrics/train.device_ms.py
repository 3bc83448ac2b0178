"""Union of the device operations' intervals per training step in the
traced window, ms."""


def read(records):
    if not records["units"]:
        return None
    return 1e3 * records["timeline"].busy_s / records["units"]
