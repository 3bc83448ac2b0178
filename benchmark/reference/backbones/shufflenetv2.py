"""ShuffleNetV2 (Ma et al., 2018) as the reference's backbone, with
notebook 03's options (``shufflenet_size``, ``shufflenet_extra_depthwise``,
``shufflenet_residuals``): fm1 stage 3's output (os16), fm2 stage 4's
(os32), the decoder's skip stage 2's (os8); ReLU in the heads."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import ConvBN, DepthwiseConvBN, _holder, conv, same_pad

SHUFFLENETV2_CHANNELS = {"0.5x": {2: 48, 3: 96, 4: 192}, "1x": {2: 116, 3: 232, 4: 464},
                         "1.5x": {2: 176, 3: 352, 4: 704}, "2x": {2: 244, 3: 488, 4: 976}}
SHUFFLENETV2_BLOCKS = ((2, 3), (3, 7), (4, 3))


def channel_shuffle(x, groups=2):
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class ShuffleNetV2(nn.ModuleDict):
    def __init__(self, size="1x", extra_depthwise=False, residuals=False):
        super().__init__()
        self.extra_depthwise, self.residuals = extra_depthwise, residuals
        channels = SHUFFLENETV2_CHANNELS[size]
        self["backbone-stage1-conv"] = _holder(3, 24, 3, bias=True)
        cin = 24
        for stage, blocks in SHUFFLENETV2_BLOCKS:
            half = channels[stage] // 2
            self._unit(f"backbone-stage{stage}-downblock-", cin, half, True)
            for b in range(blocks):
                self._unit(f"backbone-stage{stage}-block{b + 1}-", half, half, False)
            cin = channels[stage]
        self.stage_channels = channels

    def _unit(self, prefix, cin, half, down):
        branch = f"{prefix}branch-right-" if down else f"{prefix}branch-conv-"
        if down:
            self[f"{prefix}branch-left-depthconv1"] = DepthwiseConvBN(cin, 2)
            self[f"{prefix}branch-left-conv2"] = ConvBN(cin, half, relu_max=0.0)
        if self.extra_depthwise:
            self[f"{branch}depthconv0"] = DepthwiseConvBN(cin)
        self[f"{branch}conv1"] = ConvBN(cin, half, relu_max=0.0)
        self[f"{branch}depthconv2"] = DepthwiseConvBN(half, 2 if down else 1)
        self[f"{branch}conv3"] = ConvBN(half, half, relu_max=0.0 if down else None)

    def _branch(self, branch, x):
        if self.extra_depthwise:
            x = self[f"{branch}depthconv0"](x)
        for name in ("conv1", "depthconv2", "conv3"):
            x = self[f"{branch}{name}"](x)
        return x

    def forward(self, x):
        """(fm1 os16, fm2 os32, decoder skip os8)."""
        stem = self["backbone-stage1-conv"]
        x = conv(x, stem.weight, stem.bias, 2)
        top, bottom = same_pad(x.shape[2], 3, 2, 1)
        left, right = same_pad(x.shape[3], 3, 2, 1)
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
        taps = {}
        for stage, blocks in SHUFFLENETV2_BLOCKS:
            p = f"backbone-stage{stage}-downblock-"
            left_branch = self[f"{p}branch-left-conv2"](self[f"{p}branch-left-depthconv1"](x))
            x = channel_shuffle(torch.cat([left_branch, self._branch(f"{p}branch-right-", x)], 1))
            for b in range(blocks):
                identity, branch_in = x.chunk(2, dim=1)
                y = self._branch(f"backbone-stage{stage}-block{b + 1}-branch-conv-", branch_in)
                if self.residuals:
                    y = y + branch_in
                x = channel_shuffle(torch.cat([identity, F.relu(y)], 1))
            taps[stage] = x
        return taps[3], taps[4], taps[2]


def backbone(model):
    return ShuffleNetV2(model["shufflenet_size"], model["shufflenet_extra_depthwise"],
                        model["shufflenet_residuals"])


def wiring(model):
    ch = SHUFFLENETV2_CHANNELS[model["shufflenet_size"]]
    return {"fm1_channels": ch[3], "fm2_channels": ch[4], "skip_channels": ch[2], "relu_max": 0.0,
            "extra": ((ch[4], "backbone-stage5-block1"), (ch[4], "backbone-stage5-block2"))}
