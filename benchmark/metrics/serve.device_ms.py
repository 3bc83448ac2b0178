"""Union of the device operations' intervals per served batch in the
traced window, ms."""


def read(records):
    if not records["units"]:
        return None
    return 1e3 * records["timeline"].busy_s / records["units"]
