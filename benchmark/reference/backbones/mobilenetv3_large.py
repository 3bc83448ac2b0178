"""MobileNetV3-Large (Howard et al., "Searching for MobileNetV3", ICCV 2019,
arXiv:1905.02244) as the reference's backbone, written from the paper:
Table 1's stem and 15 bneck blocks at width multiplier 1.0, h-swish
``x * relu6(x + 3) / 6`` (section 5.2), squeeze-and-excitation after the
depthwise conv at ``make_divisible(expansion / 4)`` channels, its gate the
hard sigmoid ``relu6(x + 3) / 6`` (section 5.3).

Departures from the paper, each the repository's choice:
- SAME padding throughout (TF's, as the other backbones here pad);
- the taps (section 6.2's): fm1 is block 13's expansion after h-swish (C4,
  672 channels, os16), fm2 the 1x1 conv of 960 after h-swish (C5, os32,
  named block 16); the decoder's skip is block 4's expansion after ReLU (72,
  os4), the analogue of MobileNetV2's block-3 expansion;
- the segmentation head is the repository's DeepLabV3+ (rates 3/6/12) in
  place of the paper's LR-ASPP, and the heads keep ReLU6;
- the two extra SSDLite pyramid blocks take 512 and 256 channels, the first
  two depths of section 6.2's extra layers;
- the classifier (pool, 1x1 conv of 1280, 1x1 conv of 1000) is dropped, as
  section 6.2 drops it for detection.
Every convolution, the squeeze-and-excitation's two included, goes through
`reference.model.conv`, so that ``precision("fp8")`` reaches them all."""

import torch.nn as nn

from benchmark.reference.model import ConvBN, _holder, conv, relu

# Table 1: (kernel, expansion, channels out, squeeze-and-excitation,
# h-swish (else ReLU), stride) of bneck blocks 1..15
BNECK = ((3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
         (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
         (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
         (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
         (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
         (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
         (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
         (5, 960, 160, True, True, 1))


def make_divisible(value, divisor=8):
    rounded = max(divisor, int(value + divisor / 2) // divisor * divisor)
    return rounded + divisor if rounded < 0.9 * value else rounded


def hard_sigmoid(x):
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def hard_swish(x):
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def activation(hs):
    return hard_swish if hs else (lambda x: relu(x, 0.0))


class MobileNetV3Large(nn.ModuleDict):
    def __init__(self):
        super().__init__()
        self["backbone-block0-expand"] = ConvBN(3, 16, 3, 2)
        cin = 16
        for block, (k, e, cout, se, _, stride) in enumerate(BNECK, 1):
            name = f"backbone-block{block}"
            if e != cin:
                self[f"{name}-expand"] = ConvBN(cin, e)
            self[f"{name}-depthwise"] = ConvBN(e, e, k, stride, groups=e)
            if se:
                s = make_divisible(e / 4)
                self[f"{name}-se-reduce"] = _holder(e, s, 1, bias=True)
                self[f"{name}-se-expand"] = _holder(s, e, 1, bias=True)
            self[f"{name}-project"] = ConvBN(e, cout)
            cin = cout
        self["backbone-block16-expand"] = ConvBN(cin, 960)

    def forward(self, x):
        """(fm1 os16, fm2 os32, decoder skip os4)."""
        x = hard_swish(self["backbone-block0-expand"](x))
        taps, cin = {}, 16
        for block, (_, e, cout, se, hs, stride) in enumerate(BNECK, 1):
            name, act = f"backbone-block{block}", activation(hs)
            y = x
            if e != cin:
                y = taps[block] = act(self[f"{name}-expand"](x))
            y = act(self[f"{name}-depthwise"](y))
            if se:
                reduce, expand = self[f"{name}-se-reduce"], self[f"{name}-se-expand"]
                s = relu(conv(y.mean(dim=(2, 3), keepdim=True), reduce.weight, reduce.bias), 0.0)
                y = y * hard_sigmoid(conv(s, expand.weight, expand.bias))
            y = self[f"{name}-project"](y)
            x = x + y if stride == 1 and cin == cout else y
            cin = cout
        return taps[13], hard_swish(self["backbone-block16-expand"](x)), taps[4]


def backbone(model):
    return MobileNetV3Large()


def wiring(model):
    return {"fm1_channels": 672, "fm2_channels": 960, "skip_channels": 72, "relu_max": 6.0,
            "extra": ((512, "backbone-block17"), (256, "backbone-block18"))}
