"""MobileNetV2 backbone (PyTorch), counterpart of ssdseglib_tpu/models/mobilenetv2.py.

Exact channel plan of the reference (ssdseglib/models.py:47-215); block
numbering and module names mirror the reference layer names:

    stem        -> backbone-block0-{expand,depthwise,project}
    24 x2 s2    -> blocks 1-2
    32 x3 s2    -> blocks 3-5
    64 x4 s2    -> blocks 6-9
    96 x3 s1    -> blocks 10-12
    160 x3 s2   -> blocks 13-15
    320 x1 s1   -> block 16

Residual add only from the second repeat of a sequence.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ssdseglib_torch.models.blocks import ConvBN, DepthwiseConvBN

# (expansion, channels_out, n_repeat, first_stride)
_SEQUENCES: Tuple[Tuple[int, int, int, int], ...] = (
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2Backbone(nn.ModuleDict):
    """Returns (final feature map, taps dict keyed by reference layer name)."""

    def __init__(self) -> None:
        super().__init__()
        self["backbone-block0-expand"] = ConvBN(3, 32, 3, strides=2, relu_max=6.0)
        self["backbone-block0-depthwise"] = DepthwiseConvBN(32, strides=1, relu_max=6.0)
        self["backbone-block0-project"] = ConvBN(32, 16, relu_max=None)
        cin, block = 16, 0
        for expansion, cout, n_repeat, stride in _SEQUENCES:
            for n in range(n_repeat):
                block += 1
                e = cin * expansion
                self[f"backbone-block{block}-expand"] = ConvBN(cin, e, relu_max=6.0)
                self[f"backbone-block{block}-depthwise"] = DepthwiseConvBN(
                    e, strides=stride if n == 0 else 1, relu_max=6.0
                )
                self[f"backbone-block{block}-project"] = ConvBN(e, cout, relu_max=None)
                cin = cout

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        x = self["backbone-block0-expand"](x)
        x = self["backbone-block0-depthwise"](x)
        x = self["backbone-block0-project"](x)
        block = 0
        for _, _, n_repeat, _ in _SEQUENCES:
            for n in range(n_repeat):
                block += 1
                expanded = self[f"backbone-block{block}-expand"](x)
                taps[f"backbone-block{block}-expand-relu6"] = expanded
                y = self[f"backbone-block{block}-depthwise"](expanded)
                y = self[f"backbone-block{block}-project"](y)
                taps[f"backbone-block{block}-project-batchnorm"] = y
                x = x + y if n > 0 else y
        return x, taps
