"""The least time of the depthwise 3x3 convs that the depthwise kernel takes
on the cell's folded bf16 serving path at the served batch (`work.depthwise`:
bytes once at the HBM peak, taps at the f32 peak) over the device time of
the program's depthwise 3x3 kernels per batch, %.  None where no such kernel
ran, or where the configuration does not serve folded in bf16."""

from benchmark.work import depthwise


def read(records):
    serve = records["config"].get("serve", {})
    if serve.get("compute_dtype") != "bfloat16" or not serve.get("fused_backbone"):
        return None
    spent = sum(b - a for name, a, b in records["timeline"].device_ops
                if "depthwise3x3_kernel" in name)
    if spent <= 0 or not records["units"]:
        return None
    least = depthwise.least_seconds(records["config"]["model"], records["mix"]["batch"])
    return 100.0 * least["seconds"] / (spent / records["units"])
