"""Task heads (PyTorch): SSDLite detection + DeepLabV3+ segmentation.

Counterpart of ssdseglib_tpu/models/heads.py (reference ssdseglib/blocks.py
and the head assembly in models.py:217-312), including the reference quirk
kept for checkpoint parity: the labels branches use 4 output channels (the
number of box coordinates) and the boxes branches use `number_of_classes`.
Inputs and outputs of the modules are NCHW; the detection heads flatten in
NHWC order, the order of the flat anchors.  On a mesh that splits the rows
(`parallel.spatial`), a head's output of a split map is gathered in row
order, the image pooling is the global mean, and the decoder resizes to the
skip map's global size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ssdseglib_torch.parallel import spatial
from ssdseglib_torch.models.blocks import (
    ConvBN,
    SameConv2d,
    SepConvBN,
    bilinear_resize,
    dense_conv,
)


class SsdLiteBlock(nn.Module):
    """SepConv -> BN -> relu -> reshape(-1, output_channels), flattening
    (H, W, bpp * ch) row-major like the flat anchors."""

    def __init__(self, cin: int, filters: int, output_channels: int,
                 relu_max: Optional[float] = 0.0) -> None:
        super().__init__()
        self.sepconv = SepConvBN(cin, filters, 3, relu_max=relu_max)
        self.output_channels = output_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every row, so that the anchors are (row, column, box) as in one process
        x = spatial.whole(self.sepconv(x))
        # NCHW -> NHWC before the reshape, or the anchors are scrambled
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.output_channels)


class SsdLiteHeads(nn.ModuleDict):
    """Per-feature-map classification + regression branches.

    Outputs labels (B, total_boxes, 4) softmax probabilities and boxes
    (B, total_boxes, num_classes) raw offsets (see the quirk above)."""

    def __init__(self, in_channels: Sequence[int], boxes_per_point: Sequence[int],
                 number_of_classes: int, relu_max: Optional[float] = 6.0) -> None:
        super().__init__()
        for i, cin in enumerate(in_channels):
            self[f"labels{i + 1}"] = SsdLiteBlock(
                cin, boxes_per_point[i] * 4, 4, relu_max
            )
        for i, cin in enumerate(in_channels):
            self[f"boxes{i + 1}"] = SsdLiteBlock(
                cin, boxes_per_point[i] * number_of_classes, number_of_classes,
                relu_max,
            )

    def forward(self, feature_maps: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        labels = torch.cat(
            [self[f"labels{i + 1}"](fm) for i, fm in enumerate(feature_maps)], dim=1
        )
        boxes = torch.cat(
            [self[f"boxes{i + 1}"](fm) for i, fm in enumerate(feature_maps)], dim=1
        )
        return torch.softmax(labels, dim=-1), boxes


class DeepLabV3PlusEncoder(nn.ModuleDict):
    """ASPP encoder: pointwise + atrous sepconv branches + image pooling."""

    def __init__(self, cin: int, filters: int = 256,
                 dilation_rates: Tuple[int, ...] = (6, 12, 18),
                 relu_max: Optional[float] = 0.0) -> None:
        super().__init__()
        self["aspp-pointwise"] = ConvBN(cin, filters, relu_max=relu_max)
        for i, rate in enumerate(dilation_rates):
            self[f"aspp-atrous{i + 1}"] = SepConvBN(
                cin, filters, 3, dilation=rate, relu_max=relu_max
            )
        self["pooling"] = ConvBN(cin, filters, relu_max=relu_max)
        self["output"] = ConvBN(
            filters * (len(dilation_rates) + 2), filters, relu_max=relu_max
        )
        self.n_atrous = len(dilation_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self["aspp-pointwise"](x)]
        branches += [self[f"aspp-atrous{i + 1}"](x) for i in range(self.n_atrous)]
        pooled = self["pooling"](spatial.mean_hw(x))
        branches.append(spatial.expand_rows(pooled, x))
        return self["output"](torch.cat(branches, dim=1))


class DeepLabV3PlusDecoder(nn.ModuleDict):
    """Skip-refined decoder producing the softmax segmentation mask:
    upsample the encoder to the skip resolution, reduce the skip with a
    pointwise conv, concat, refine with conv + sepconv, project to classes,
    upsample to full resolution, softmax."""

    def __init__(self, encoder_channels: int, skip_channels: int,
                 filters_backbone: int = 48, filters_decoder: int = 256,
                 output_height_width: Tuple[int, int] = (480, 640),
                 output_channels: int = 4,
                 relu_max: Optional[float] = 0.0) -> None:
        super().__init__()
        self["backbone-reduce"] = ConvBN(skip_channels, filters_backbone,
                                         relu_max=relu_max)
        self["conv"] = ConvBN(encoder_channels + filters_backbone, filters_decoder,
                              3, relu_max=relu_max)
        self["sepconv"] = SepConvBN(filters_decoder, filters_decoder, 3,
                                    relu_max=relu_max)
        self["output-conv"] = SameConv2d(filters_decoder, output_channels, 3)
        self.output_height_width = tuple(output_height_width)

    def forward(self, encoder: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        encoder = bilinear_resize(encoder, *spatial.global_size(skip))
        skip = self["backbone-reduce"](skip)
        x = self["conv"](torch.cat([encoder, skip], dim=1))
        x = dense_conv(self["output-conv"], self["sepconv"](x))
        x = bilinear_resize(x, *self.output_height_width)
        return torch.softmax(x, dim=1)
