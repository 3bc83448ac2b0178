"""MobileNetV2 (Sandler et al., 2018) as the reference's backbone, the
feature maps of notebook 03's builder: fm1 the expansion of block 13
(os16, 576 channels), fm2 block 16's output (os32, 320), the decoder's
skip the expansion of block 3 (os4, 144); ReLU6 in the heads."""

import torch.nn as nn

from benchmark.reference.model import ConvBN, DepthwiseConvBN

# MobileNetV2: (expansion, channels out, repeats, first stride)
MOBILENETV2_SEQUENCES = ((6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.ModuleDict):
    def __init__(self):
        super().__init__()
        self["backbone-block0-expand"] = ConvBN(3, 32, 3, 2, relu_max=6.0)
        self["backbone-block0-depthwise"] = DepthwiseConvBN(32, 1, 6.0)
        self["backbone-block0-project"] = ConvBN(32, 16)
        cin, block = 16, 0
        for expansion, cout, repeats, stride in MOBILENETV2_SEQUENCES:
            for n in range(repeats):
                block += 1
                e = cin * expansion
                self[f"backbone-block{block}-expand"] = ConvBN(cin, e, relu_max=6.0)
                self[f"backbone-block{block}-depthwise"] = DepthwiseConvBN(
                    e, stride if n == 0 else 1, 6.0)
                self[f"backbone-block{block}-project"] = ConvBN(e, cout)
                cin = cout

    def forward(self, x):
        """(fm1 os16, fm2 os32, decoder skip os4)."""
        for name in ("expand", "depthwise", "project"):
            x = self[f"backbone-block0-{name}"](x)
        taps, block = {}, 0
        for _, _, repeats, _ in MOBILENETV2_SEQUENCES:
            for n in range(repeats):
                block += 1
                e = self[f"backbone-block{block}-expand"](x)
                taps[f"expand{block}"] = e
                y = self[f"backbone-block{block}-project"](self[f"backbone-block{block}-depthwise"](e))
                x = x + y if n > 0 else y
            taps[f"out{block}"] = x
        return taps["expand13"], taps["out16"], taps["expand3"]


def backbone(model):
    return MobileNetV2()


def wiring(model):
    return {"fm1_channels": 576, "fm2_channels": 320, "skip_channels": 144, "relu_max": 6.0,
            "extra": ((320, "backbone-block17"), (360, "backbone-block18"))}
