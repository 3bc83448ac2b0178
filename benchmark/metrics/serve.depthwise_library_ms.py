"""Device time per served batch of the library's depthwise convolutions,
ms: on MobileNetV3-Large's folded bf16 path, the six 5x5 depthwise convs
that the depthwise kernel does not take.  cuDNN runs them as
``conv2d_c1_k1_nhwc_specialized`` or ``convolve_common_engine_float_NHWC``
(as traced on an H100 with PyTorch 2.11.0+cu128), or as its grouped
direct kernel; the `F.pad` copies and bias and activation passes around
them are not counted.  None where no such operation ran."""

LIBRARY_KERNELS = ("conv2d_c1_k1_nhwc", "convolve_common_engine", "conv2d_grouped")


def read(records):
    spent = sum(b - a for name, a, b in records["timeline"].device_ops
                if any(k in name for k in LIBRARY_KERNELS))
    if spent <= 0 or not records["units"]:
        return None
    return 1e3 * spent / records["units"]
