"""The joint network in plain float32 PyTorch (NCHW, TF32 off by the caller).

Parameter names are those of the raw weights the harness draws (a module
tree of ``nn.Conv2d`` and ``nn.BatchNorm2d`` holders); every forward is
written out with ``F.conv2d`` on explicitly padded inputs.

`precision("fp8")` is the correctness control, the next precision below the
bf16 that the configurations serve and train in, as fp8 training runs it:
every convolution's input and weight are rounded to float8 e4m3 and the
gradient of its output to float8 e5m2, each with one scale per tensor (its
largest magnitude over the format's largest value), around an f32 product.
"""

from __future__ import annotations

import contextlib
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.harness.catalog import load_module

BN_EPSILON = 1e-3
FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0
_MODE = {"precision": "float32", "trace": None}

BACKBONES = Path(__file__).resolve().parent / "backbones"


@contextlib.contextmanager
def precision(name: str):
    """Run the convolutions in ``name``: 'float32' or 'fp8' (the control)."""
    if name not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {name!r}")
    previous, _MODE["precision"] = _MODE["precision"], name
    try:
        yield
    finally:
        _MODE["precision"] = previous


def _fp8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


def _operand(t: torch.Tensor) -> torch.Tensor:
    if _MODE["precision"] == "float32":
        return t
    return t + (_fp8(t.detach(), torch.float8_e4m3fn, FP8_E4M3_MAX) - t.detach())


class _GradientFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _fp8(dy, torch.float8_e5m2, FP8_E5M2_MAX)


def same_pad(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """TF "SAME" padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv(x, weight, bias=None, stride: int = 1, dilation: int = 1, groups: int = 1):
    top, bottom = same_pad(x.shape[2], weight.shape[2], stride, dilation)
    left, right = same_pad(x.shape[3], weight.shape[3], stride, dilation)
    x = F.pad(x, (left, right, top, bottom))
    out = F.conv2d(_operand(x), _operand(weight), bias, stride, 0, dilation, groups)
    if _MODE["precision"] == "fp8" and out.requires_grad:
        out = _GradientFp8.apply(out)
    if _MODE["trace"] is not None:
        _MODE["trace"].append((tuple(weight.shape), tuple(out.shape), groups))
    return out


def relu(x, relu_max: Optional[float]):
    """None: no activation; 0: ReLU; above 0: ReLU capped there."""
    if relu_max is None:
        return x
    return x.clamp(0.0, relu_max) if relu_max > 0 else F.relu(x)


class Norm(nn.BatchNorm2d):
    """Keras BatchNorm: batch statistics (biased variance) in train mode,
    running statistics in eval mode; ``(x - mean) * (rsqrt(var + eps) *
    gamma) + beta``."""

    def __init__(self, channels: int) -> None:
        super().__init__(channels, eps=BN_EPSILON)

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


def _holder(cin, cout, k, groups=1, bias=False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, groups=groups, bias=bias)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, dilation=1, relu_max=None, groups=1):
        super().__init__()
        self.conv = _holder(cin, cout, k, groups)
        self.batchnorm = Norm(cout)
        self.stride, self.dilation, self.groups, self.relu_max = stride, dilation, groups, relu_max

    def forward(self, x):
        x = conv(x, self.conv.weight, None, self.stride, self.dilation, self.groups)
        return relu(self.batchnorm(x), self.relu_max)


def DepthwiseConvBN(channels, stride=1, relu_max=None):
    return ConvBN(channels, channels, 3, stride, 1, relu_max, groups=channels)


class SepConvBN(nn.Module):
    """Depthwise then pointwise, one BatchNorm after the pointwise."""

    def __init__(self, cin, cout, k=3, stride=1, dilation=1, relu_max=None):
        super().__init__()
        self.depthwise = _holder(cin, cin, k, groups=cin)
        self.pointwise = _holder(cin, cout, 1)
        self.batchnorm = Norm(cout)
        self.stride, self.dilation, self.cin, self.relu_max = stride, dilation, cin, relu_max

    def forward(self, x):
        x = conv(x, self.depthwise.weight, None, self.stride, self.dilation, self.cin)
        x = conv(x, self.pointwise.weight)
        return relu(self.batchnorm(x), self.relu_max)


class SsdLiteBlock(nn.Module):
    def __init__(self, cin, filters, out_channels, relu_max):
        super().__init__()
        self.sepconv = SepConvBN(cin, filters, 3, relu_max=relu_max)
        self.out_channels = out_channels

    def forward(self, x):
        x = self.sepconv(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.out_channels)


class Heads(nn.ModuleDict):
    """SSDLite: labels branches of 4 channels, boxes branches of
    ``classes`` channels (the reference's swap, kept)."""

    def __init__(self, in_channels, boxes_per_point, classes, relu_max):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self[f"labels{i + 1}"] = SsdLiteBlock(cin, boxes_per_point[i] * 4, 4, relu_max)
        for i, cin in enumerate(in_channels):
            self[f"boxes{i + 1}"] = SsdLiteBlock(cin, boxes_per_point[i] * classes, classes, relu_max)
        self.n = len(in_channels)

    def forward(self, maps):
        labels = torch.cat([self[f"labels{i + 1}"](m) for i, m in enumerate(maps)], 1)
        boxes = torch.cat([self[f"boxes{i + 1}"](m) for i, m in enumerate(maps)], 1)
        return torch.softmax(labels, -1), boxes


class Encoder(nn.ModuleDict):
    """ASPP: pointwise, three atrous separable convs, image pooling."""

    def __init__(self, cin, filters, rates, relu_max):
        super().__init__()
        self["aspp-pointwise"] = ConvBN(cin, filters, relu_max=relu_max)
        for i, rate in enumerate(rates):
            self[f"aspp-atrous{i + 1}"] = SepConvBN(cin, filters, 3, dilation=rate, relu_max=relu_max)
        self["pooling"] = ConvBN(cin, filters, relu_max=relu_max)
        self["output"] = ConvBN(filters * (len(rates) + 2), filters, relu_max=relu_max)
        self.n = len(rates)

    def forward(self, x):
        branches = [self["aspp-pointwise"](x)]
        branches += [self[f"aspp-atrous{i + 1}"](x) for i in range(self.n)]
        pooled = self["pooling"](x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self["output"](torch.cat(branches, 1))


class Decoder(nn.ModuleDict):
    def __init__(self, enc_c, skip_c, out_hw, classes, relu_max):
        super().__init__()
        self["backbone-reduce"] = ConvBN(skip_c, 48, relu_max=relu_max)
        self["conv"] = ConvBN(enc_c + 48, 256, 3, relu_max=relu_max)
        self["sepconv"] = SepConvBN(256, 256, 3, relu_max=relu_max)
        self["output-conv"] = _holder(256, classes, 3)
        self.out_hw = tuple(out_hw)

    def forward(self, encoder, skip):
        encoder = F.interpolate(encoder, size=skip.shape[2:], mode="bilinear", align_corners=False)
        x = self["conv"](torch.cat([encoder, self["backbone-reduce"](skip)], 1))
        x = conv(self["sepconv"](x), self["output-conv"].weight)
        x = F.interpolate(x, size=self.out_hw, mode="bilinear", align_corners=False)
        return torch.softmax(x, 1)


def backbone(name: str) -> ModuleType:
    """The backbone ``name``: ``backbones/<name>.py``, loaded by path.  It
    builds on this module's primitives and exposes ``backbone(model)``, the
    module whose forward takes NCHW images in [-1, 1] and returns (fm1 at
    os16, fm2 at os32, the decoder's skip), and ``wiring(model)``, what the
    heads take from it: ``fm1_channels``, ``fm2_channels``,
    ``skip_channels``, the heads' ``relu_max`` and ``extra``, the two extra
    pyramid blocks as (channels, name)."""
    return load_module(BACKBONES / f"{name}.py", "bench_reference_backbone_" + re.sub(r"\W", "_", name))


class Network(nn.ModuleDict):
    """Backbone + DeepLabV3+ + SSDLite.  ``forward`` takes NHWC images in
    [0, 255] and returns the mask (B, H, W, C) and labels (B, N, 4)
    probabilities and the raw box offsets (B, N, C)."""

    def __init__(self, model: Dict) -> None:
        super().__init__()
        classes = model["number_of_classes"]
        source = backbone(model["backbone"])
        self["backbone"] = source.backbone(model)
        wiring = source.wiring(model)
        fm1_c, fm2_c, skip_c = (wiring[k] for k in ("fm1_channels", "fm2_channels", "skip_channels"))
        relu_max, extra = wiring["relu_max"], wiring["extra"]
        self[extra[0][1]] = SepConvBN(fm2_c, extra[0][0], 3, 2, relu_max=relu_max)
        self[extra[1][1]] = SepConvBN(extra[0][0], extra[1][0], 3, 2, relu_max=relu_max)
        self["mask-encoder"] = Encoder(fm1_c, 256, model["segmentation_dilation_rates"], relu_max)
        self["mask-decoder"] = Decoder(256, skip_c, model["input_image_shape"][:2], classes, relu_max)
        self["heads"] = Heads((fm1_c, fm2_c, extra[0][0], extra[1][0]), model["boxes_per_point"],
                              classes, relu_max)
        self.extra = tuple(name for _, name in extra)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2) / 127.5 - 1.0
        fm1, fm2, skip = self["backbone"](x)
        fm3 = self[self.extra[0]](fm2)
        fm4 = self[self.extra[1]](fm3)
        mask = self["mask-decoder"](self["mask-encoder"](fm1), skip)
        labels, boxes = self["heads"]([fm1, fm2, fm3, fm4])
        return mask.permute(0, 2, 3, 1), labels, boxes


def build(model: Dict, weights: Dict[str, torch.Tensor], device) -> Network:
    """The network on ``device`` in f32, holding ``weights`` (every name of
    the raw weights, BatchNorm statistics included)."""
    net = Network(model).to(device)
    missing, unexpected = net.load_state_dict(
        {k: v.float() for k, v in weights.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the reference: missing {missing[:4]}, "
                         f"unexpected {unexpected[:4]}")
    return net.eval()


def conv_shapes(model: Dict, batch: int = 1) -> List[Tuple[tuple, tuple, int]]:
    """(weight shape, output shape, groups) of every convolution of one
    forward at the configuration's input size, traced on the meta device."""
    net = Network(model).to("meta")
    seen: List[Tuple[tuple, tuple, int]] = []
    _MODE["trace"] = seen
    try:
        with torch.no_grad():
            net(torch.empty(batch, *model["input_image_shape"], device="meta"))
    finally:
        _MODE["trace"] = None
    return seen
