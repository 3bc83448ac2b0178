"""Primitive conv blocks (PyTorch), counterpart of ssdseglib_tpu/models/blocks.py.

conv -> batchnorm -> (capped) relu, the depthwise variant, and the
Keras-style SeparableConv (depthwise then pointwise, batchnorm after the
pointwise only).  Every conv pads TF/XLA "SAME" (`conv2d_same`): for a
stride-2 conv on an even size that is 0 before and 1 after, which torch's
symmetric ``padding=`` cannot express.

Tensors are NCHW in the channels-last memory format.  Module and parameter
names mirror the Flax tree ("conv", "batchnorm", "depthwise", "pointwise"),
so ``weights.py`` bridges the two by a rename plus a transpose.

Activation convention (``relu_max``): None = no activation, 0.0 = uncapped
ReLU, x > 0 = ReLU capped at x.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPSILON = 1e-3
# torch's momentum weighs the new batch statistic: 1 - Flax's 0.99
BN_MOMENTUM = 0.01


def same_pad(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """TF/XLA SAME padding (before, after) of one spatial axis."""
    effective = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with SAME padding; pads explicitly only when the
    padding is asymmetric."""
    (top, bottom) = same_pad(x.shape[2], weight.shape[2], stride, dilation)
    (left, right) = same_pad(x.shape[3], weight.shape[3], stride, dilation)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left), dilation, groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, stride, 0, dilation, groups)


def apply_relu(x: torch.Tensor, relu_max: Optional[float]) -> torch.Tensor:
    if relu_max is None:
        return x
    if relu_max > 0.0:
        return x.clamp(0.0, relu_max)
    return F.relu(x)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's default conv init (lecun_normal: variance 1/fan_in, normal
    truncated at two standard deviations), drawn from ``generator``."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    # std of a unit normal truncated to [-2, 2]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def batchnorm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPSILON, momentum=BN_MOMENTUM)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias) with SAME padding."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1) -> None:
        super().__init__(cin, cout, kernel_size, stride=stride, dilation=dilation,
                         groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, None, self.stride[0],
                           self.dilation[0], self.groups)


class ConvBN(nn.Module):
    """Pointwise/standard conv -> batchnorm -> optional capped relu."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 strides: int = 1, dilation: int = 1,
                 relu_max: Optional[float] = None) -> None:
        super().__init__()
        self.conv = SameConv2d(cin, features, kernel_size, strides, dilation)
        self.batchnorm = batchnorm(features)
        self.relu_max = relu_max

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_relu(self.batchnorm(self.conv(x)), self.relu_max)


class DepthwiseConvBN(nn.Module):
    """Depthwise conv (one filter per channel) -> batchnorm -> optional relu."""

    def __init__(self, channels: int, kernel_size: int = 3, strides: int = 1,
                 dilation: int = 1, relu_max: Optional[float] = None) -> None:
        super().__init__()
        self.conv = SameConv2d(channels, channels, kernel_size, strides, dilation,
                               groups=channels)
        self.batchnorm = batchnorm(channels)
        self.relu_max = relu_max

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_relu(self.batchnorm(self.conv(x)), self.relu_max)


class SepConvBN(nn.Module):
    """Keras-style SeparableConv2D + BN + optional relu: depthwise then
    pointwise with nothing in between, one batchnorm after the pointwise."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1,
                 relu_max: Optional[float] = None) -> None:
        super().__init__()
        self.depthwise = SameConv2d(cin, cin, kernel_size, strides, dilation,
                                    groups=cin)
        self.pointwise = SameConv2d(cin, features, 1)
        self.batchnorm = batchnorm(features)
        self.relu_max = relu_max

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pointwise(self.depthwise(x))
        return apply_relu(self.batchnorm(x), self.relu_max)


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (``jax.image.resize``
    'bilinear' / ``tf.image.resize``); the serving path only upsamples,
    where no antialiasing applies."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Flax-default init of every conv in ``module`` from ``generator``;
    BatchNorm keeps torch's defaults (scale 1, bias 0, mean 0, var 1),
    which are Flax's too."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
