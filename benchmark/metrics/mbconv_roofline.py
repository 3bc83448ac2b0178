"""The ten stride-1 MBConv blocks' least time at the served batch
(`work.mbconv`: operations at the bf16 dense peak, bytes once at the HBM
peak) over the device time of the program's MBConv kernels per batch, %.
None where no MBConv kernel ran."""


def read(records):
    spent = sum(b - a for name, a, b in records["timeline"].device_ops if "mbconv" in name.lower())
    if spent <= 0 or not records["units"]:
        return None
    return 100.0 * records["work"]["mbconv_least_s_per_batch"] / (spent / records["units"])
