"""ShuffleNetV2 backbone (PyTorch), counterpart of ssdseglib_tpu/models/shufflenetv2.py.

Reference: ssdseglib/models.py:425-652.  Stage channel presets per model
size (models.py:459-468): 0.5x {48, 96, 192}, 1x {116, 232, 464},
1.5x {176, 352, 704}, 2x {244, 488, 976}.  Stage 1 is a 3x3 stride-2 conv
with a bias (no BatchNorm, no activation) and a SAME 3x3 stride-2 max pool;
stages 2/3/4 are one downsampling unit followed by 3/7/3 basic units.

Taps returned (reference models.py:666-667, :748):
    'backbone-stage2-block3' (os8 skip for the mask decoder)
    'backbone-stage3-block7' (os16)
    'backbone-stage4-block3' (os32)

Options: `use_additional_depthwise_convolution` adds a depthwise conv before
the first pointwise of each unit's convolution branch (models.py:532-537,
:576-581); `use_residual_connections` adds the basic unit's residual add
(models.py:592).  Module names are the Flax names, so ``weights.py`` bridges
the two by a rename.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssdseglib_torch.models.blocks import (
    ConvBN,
    DepthwiseConvBN,
    SameConv2d,
    channel_shuffle,
    dense_conv,
    max_pool_same,
)

STAGE_CHANNELS = {
    "0.5x": {2: 48, 3: 96, 4: 192},
    "1x": {2: 116, 3: 232, 4: 464},
    "1.5x": {2: 176, 3: 352, 4: 704},
    "2x": {2: 244, 3: 488, 4: 976},
}
STAGE_BLOCKS = ((2, 3), (3, 7), (4, 3))  # (stage, basic units)
STEM_CHANNELS = 24


class ShuffleNetV2Backbone(nn.ModuleDict):
    """Returns (final feature map, taps dict keyed by reference layer name)."""

    def __init__(self, model_size: str = "1x",
                 use_additional_depthwise_convolution: bool = False,
                 use_residual_connections: bool = False) -> None:
        super().__init__()
        self.extra_depthwise = use_additional_depthwise_convolution
        self.residuals = use_residual_connections
        channels = STAGE_CHANNELS[model_size]
        self["backbone-stage1-conv"] = SameConv2d(3, STEM_CHANNELS, 3, stride=2, bias=True)
        cin = STEM_CHANNELS
        for stage, n_blocks in STAGE_BLOCKS:
            half = channels[stage] // 2
            self._add_unit(f"backbone-stage{stage}-downblock-", cin, half, down=True)
            for b in range(n_blocks):
                self._add_unit(f"backbone-stage{stage}-block{b + 1}-", half, half, down=False)
            cin = channels[stage]

    def _add_unit(self, prefix: str, cin: int, half: int, down: bool) -> None:
        """A downsampling unit (two stride-2 branches of ``cin`` inputs) or a
        basic unit (one branch on the second half of the channels)."""
        branch = f"{prefix}branch-right-" if down else f"{prefix}branch-conv-"
        if down:
            self[f"{prefix}branch-left-depthconv1"] = DepthwiseConvBN(cin, strides=2)
            self[f"{prefix}branch-left-conv2"] = ConvBN(cin, half, relu_max=0.0)
        if self.extra_depthwise:
            self[f"{branch}depthconv0"] = DepthwiseConvBN(cin)
        self[f"{branch}conv1"] = ConvBN(cin, half, relu_max=0.0)
        self[f"{branch}depthconv2"] = DepthwiseConvBN(half, strides=2 if down else 1)
        # the basic unit's last pointwise has its ReLU after the residual add
        self[f"{branch}conv3"] = ConvBN(half, half, relu_max=0.0 if down else None)

    def _branch(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        if self.extra_depthwise:
            x = self[f"{branch}depthconv0"](x)
        x = self[f"{branch}conv1"](x)
        x = self[f"{branch}depthconv2"](x)
        return self[f"{branch}conv3"](x)

    def _downsampling_unit(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        left = self[f"{prefix}branch-left-depthconv1"](x)
        left = self[f"{prefix}branch-left-conv2"](left)
        right = self._branch(f"{prefix}branch-right-", x)
        return channel_shuffle(torch.cat([left, right], dim=1))

    def _basic_unit(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        identity, branch_in = x.chunk(2, dim=1)
        branch = self._branch(f"{prefix}branch-conv-", branch_in)
        if self.residuals:
            branch = branch + branch_in
        return channel_shuffle(torch.cat([identity, F.relu(branch)], dim=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        x = max_pool_same(dense_conv(self["backbone-stage1-conv"], x))
        for stage, n_blocks in STAGE_BLOCKS:
            x = self._downsampling_unit(f"backbone-stage{stage}-downblock-", x)
            for b in range(n_blocks):
                x = self._basic_unit(f"backbone-stage{stage}-block{b + 1}-", x)
            taps[f"backbone-stage{stage}-block{n_blocks}"] = x
        return x, taps
