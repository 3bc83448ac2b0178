"""The least time of the MobileNetV2 stride-1 inverted-residual (MBConv)
blocks, the work of the program's fused MBConv kernel, from their shapes.

A block of Cin = Cout = C channels, expansion 6 (E = 6 C), on an H x W map:
a 1x1 expand C -> E with bias and ReLU6, a 3x3 depthwise with bias and
ReLU6, a 1x1 project E -> C with bias, and the residual add.
- operations: 2 multiply-adds' worth per product, H W (C E + 9 E + E C),
  all at the bf16 dense tensor-core peak (the taps are counted at the same
  rate: the work, not one kernel's choice of units);
- bytes: the input and the output once, each weight and bias once, at 2
  bytes (bf16), at the HBM peak.
Least time = max(operations / peak, bytes / bandwidth), the roofline.

At 480 x 640 the ten blocks are MobileNetV2's repeats 2 (C 24, os4), 4-5
(32, os8), 7-9 (64, os16), 11-12 (96, os16) and 14-15 (160, os32)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.work import peaks

EXPANSION = 6
SEQUENCES = ((6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
             (6, 320, 1, 1))


def blocks(image_hw=(480, 640)) -> List[Tuple[int, int, int]]:
    """(channels, rows, columns) of every stride-1 residual repeat."""
    h, w = -(-image_hw[0] // 2), -(-image_hw[1] // 2)   # the stem's stride 2
    out = []
    for _, c, repeats, stride in SEQUENCES:
        h, w = -(-h // stride), -(-w // stride)
        out += [(c, h, w)] * (repeats - 1)
    return out


def block_work(c: int, h: int, w: int, batch: int, elem: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one block at ``batch``."""
    e = EXPANSION * c
    ops = 2.0 * batch * h * w * (c * e + 9 * e + e * c)
    weights = c * e + e + 9 * e + e + e * c + c
    nbytes = elem * (2.0 * batch * h * w * c + weights)
    return ops, nbytes


def least_seconds(batch: int, image_hw=(480, 640)) -> Dict[str, float]:
    """The ten blocks' least time at ``batch`` and what bounds each."""
    total, by_ops, by_bytes = 0.0, 0.0, 0.0
    for c, h, w in blocks(image_hw):
        ops, nbytes = block_work(c, h, w, batch)
        t_ops, t_bytes = ops / peaks.BF16_DENSE_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        by_ops += t_ops
        by_bytes += t_bytes
    return {"seconds": total, "operations_s": by_ops, "bytes_s": by_bytes}
