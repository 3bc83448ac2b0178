"""MobileNetV3-Large backbone (PyTorch), from Howard et al., "Searching for
MobileNetV3", ICCV 2019 (arXiv:1905.02244): Table 1 at width multiplier 1.0,
h-swish (section 5.2), squeeze-and-excitation at a quarter of the expansion
(section 5.3).  The port's own: the JAX package has no such backbone.

Module names follow `mobilenetv2.py`'s:

    stem, conv 3x3 16 s2, h-swish    -> backbone-block0-expand
    bneck n = 1..15 (Table 1)        -> backbone-block{n}-{expand, depthwise,
                                        se-reduce, se-expand, project}
    conv 1x1 960, h-swish            -> backbone-block16-expand

Block 1 has no expansion conv (its expansion equals its input).  The
squeeze-and-excitation sits after the depthwise conv's activation, its two
1x1 convs with biases at ``make_divisible(expansion / 4)`` channels; the
residual is added where the stride is 1 and the input's channels are the
output's.  The classifier (pool, 1280, 1000) is dropped, as section 6.2
drops it for detection.  Every conv pads SAME (`blocks.conv2d_same`), as the
port's other backbones do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ssdseglib_torch.models.blocks import (
    ConvBN,
    DepthwiseConvBN,
    SameConv2d,
    squeeze_excite,
)

# Table 1: (kernel, expansion, channels out, squeeze-and-excitation,
# h-swish (else ReLU), stride) of bneck blocks 1..15
BNECK: Tuple[Tuple[int, int, int, bool, bool, int], ...] = (
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)
STEM_CHANNELS = 16
LAST_CHANNELS = 960
LAST_BLOCK = len(BNECK) + 1  # the 1x1 conv of 960, named as block 16


def make_divisible(value: float, divisor: int = 8) -> int:
    """The nearest multiple of ``divisor``, at least ``divisor``, and not
    under 90 % of ``value`` (the rounding of the paper's reference code)."""
    rounded = max(divisor, int(value + divisor / 2) // divisor * divisor)
    return rounded + divisor if rounded < 0.9 * value else rounded


def squeeze_channels(expansion: int) -> int:
    return make_divisible(expansion / 4)


def activation_args(hard_swish: bool) -> Dict[str, object]:
    """``ConvBN`` / ``DepthwiseConvBN`` keywords of a block's activation:
    h-swish, or the uncapped ReLU."""
    return {"activation": "hard_swish"} if hard_swish else {"relu_max": 0.0}


class MobileNetV3LargeBackbone(nn.ModuleDict):
    """Returns (final feature map, taps keyed by module name): the activated
    output of every ``-expand`` conv under its module name."""

    def __init__(self) -> None:
        super().__init__()
        self["backbone-block0-expand"] = ConvBN(3, STEM_CHANNELS, 3, strides=2,
                                                activation="hard_swish")
        cin = STEM_CHANNELS
        for block, (k, e, cout, se, hs, stride) in enumerate(BNECK, 1):
            act = activation_args(hs)
            name = f"backbone-block{block}"
            if e != cin:
                self[f"{name}-expand"] = ConvBN(cin, e, **act)
            self[f"{name}-depthwise"] = DepthwiseConvBN(e, k, strides=stride, **act)
            if se:
                s = squeeze_channels(e)
                self[f"{name}-se-reduce"] = SameConv2d(e, s, 1, bias=True)
                self[f"{name}-se-expand"] = SameConv2d(s, e, 1, bias=True)
            self[f"{name}-project"] = ConvBN(e, cout)
            cin = cout
        self[f"backbone-block{LAST_BLOCK}-expand"] = ConvBN(cin, LAST_CHANNELS,
                                                            activation="hard_swish")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        x = self["backbone-block0-expand"](x)
        cin = STEM_CHANNELS
        for block, (_, e, cout, se, _, stride) in enumerate(BNECK, 1):
            name = f"backbone-block{block}"
            y = x
            if e != cin:
                y = taps[f"{name}-expand"] = self[f"{name}-expand"](x)
            y = self[f"{name}-depthwise"](y)
            if se:
                y = squeeze_excite(y, self[f"{name}-se-reduce"], self[f"{name}-se-expand"])
            y = self[f"{name}-project"](y)
            x = x + y if stride == 1 and cin == cout else y
            cin = cout
        name = f"backbone-block{LAST_BLOCK}-expand"
        x = taps[name] = self[name](x)
        return x, taps
