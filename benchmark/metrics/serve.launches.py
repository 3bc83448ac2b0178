"""Device operations (kernels, copies, sets) per served batch in the
traced window."""


def read(records):
    if not records["units"]:
        return None
    return len(records["timeline"].device_ops) / records["units"]
