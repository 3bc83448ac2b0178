"""The least time of the depthwise 3x3 convolutions that the program's
depthwise kernel takes on a cell's serving path, from the configuration's
shapes.

The kernel takes every 3x3 depthwise conv of the folded bf16 forward but
those inside MobileNetV2's stride-1 residual repeats, which the MBConv
kernel runs: 21 a forward on MobileNetV2 (block 0, the six first blocks,
the two extra blocks, three ASPP branches, the decoder, eight heads), 23 on
MobileNetV3-Large (its nine 3x3 bneck convs and the same fourteen of the
heads).  Each is found by the reference module that holds it, traced on the
meta device: a ``ConvBN`` whose groups are its channels (a folded bias) or
a ``SepConvBN``'s depthwise half (no bias), with a 3x3 kernel.
- bytes: the input and the output once, the taps and the bias once, at 2
  bytes (bf16), at the HBM peak;
- operations: 2 x 9 taps an output element, on the CUDA cores at the f32
  peak (the rate `PERF.md`'s kernel table bounds the kernel by).
Least time = the sum over the convs of max(operations / peak, bytes /
bandwidth), the roofline."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import model as ref_model
from benchmark.work import mbconv, peaks

KERNEL = 3


def _mbconv_depthwise(model: Dict) -> set:
    """Module names of the depthwise convs that the MBConv kernel runs."""
    if model["backbone"] != "mobilenetv2":
        return set()
    names, block = set(), 0
    for _, _, repeats, _ in mbconv.SEQUENCES:
        for n in range(repeats):
            block += 1
            if n > 0:
                names.add(f"backbone.backbone-block{block}-depthwise")
    return names


def convs(model: Dict) -> List[Tuple[int, int, int, int, int, int, bool]]:
    """(H, W, C, Ho, Wo, stride, bias) of every conv the kernel takes in one
    forward of one image, in the forward's order."""
    net = ref_model.Network(model).to("meta")
    skip = _mbconv_depthwise(model)
    seen, hooks = [], []

    def hook(stride, bias):
        def record(module, inputs):
            _, c, h, w = inputs[0].shape
            seen.append((h, w, c, -(-h // stride), -(-w // stride), stride, bias))
        return record

    for name, m in net.named_modules():
        if isinstance(m, ref_model.ConvBN):
            weight, bias = m.conv.weight, True
            if m.groups != weight.shape[0] or m.groups == 1:
                continue
        elif isinstance(m, ref_model.SepConvBN):
            weight, bias = m.depthwise.weight, False
        else:
            continue
        if tuple(weight.shape[2:]) == (KERNEL, KERNEL) and name not in skip:
            hooks.append(m.register_forward_pre_hook(hook(m.stride, bias)))
    try:
        with torch.no_grad():
            net(torch.empty(1, *model["input_image_shape"], device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return seen


def least_seconds(model: Dict, batch: int) -> Dict[str, float]:
    """The kernel's convs' least time at ``batch`` and what bounds them."""
    total, by_ops, by_bytes = 0.0, 0.0, 0.0
    for h, w, c, ho, wo, _, bias in convs(model):
        nbytes = 2.0 * (batch * c * (h * w + ho * wo) + c * (KERNEL * KERNEL + int(bias)))
        ops = 2.0 * KERNEL * KERNEL * batch * ho * wo * c
        t_ops, t_bytes = ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        by_ops += t_ops
        by_bytes += t_bytes
    return {"seconds": total, "operations_s": by_ops, "bytes_s": by_bytes}
