"""A plain float PyTorch MobileNetV3-Large backbone for the tests, written
from Howard et al., "Searching for MobileNetV3", ICCV 2019
(arXiv:1905.02244), independent of the port and of the benchmark: Table 1's
stem and 15 bneck blocks at width multiplier 1.0; h-swish
``x * relu6(x + 3) / 6`` (section 5.2); squeeze-and-excitation after the
depthwise conv, ``x * relu6(W2 relu(W1 mean(x) + b1) + b2 + 3) / 6``, at
``make_divisible(expansion / 4)`` channels (section 5.3); the residual where
the stride is 1 and the channels in equal those out.  Every conv is
``F.conv2d`` on an explicitly padded input, every BatchNorm written out
(Keras': eps 1e-3, the biased batch variance in train mode).

Departures from the paper: SAME padding (the port's); the taps of section
6.2 and the decoder's skip (block 13's expansion, os16; the 1x1 conv of 960,
os32; block 4's expansion, os4); the classifier dropped.  Parameter names
are the port's (``backbone-block{n}-{expand, depthwise, se-reduce,
se-expand, project}``, block 16 the 1x1 conv of 960), so a state dict loads
in both.  Imports nothing of the port, of the benchmark or of JAX."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-3
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


def relu6(x):
    return x.clamp(0.0, 6.0)


def hard_swish(x):
    return x * relu6(x + 3.0) / 6.0


def hard_sigmoid(x):
    return relu6(x + 3.0) / 6.0


def same_conv(x, weight, bias=None, stride=1, groups=1):
    """TF "SAME" padding, then ``F.conv2d``."""
    pads = []
    for size, k in ((x.shape[3], weight.shape[3]), (x.shape[2], weight.shape[2])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), weight, bias, stride, 0, 1, groups)


class _BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + EPS)
        return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class _ConvBN(nn.Module):
    """conv (no bias) then BatchNorm; the activation is the caller's."""

    def __init__(self, cin, cout, k=1, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.batchnorm = _BatchNorm(cout)
        self.stride, self.groups = stride, groups

    def forward(self, x):
        return self.batchnorm(same_conv(x, self.conv.weight, None, self.stride, self.groups))


class _Conv(nn.Module):
    """A 1x1 conv with a bias."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias)


class MobileNetV3Large(nn.ModuleDict):
    """``forward(x)``: NCHW images in [-1, 1] -> (fm1, fm2, skip)."""

    def __init__(self):
        super().__init__()
        self["backbone-block0-expand"] = _ConvBN(3, 16, 3, 2)
        cin = 16
        for n, (k, e, cout, se, _, stride) in enumerate(BNECK, 1):
            if e != cin:
                self[f"backbone-block{n}-expand"] = _ConvBN(cin, e)
            self[f"backbone-block{n}-depthwise"] = _ConvBN(e, e, k, stride, groups=e)
            if se:
                s = make_divisible(e / 4)
                self[f"backbone-block{n}-se-reduce"] = _Conv(e, s)
                self[f"backbone-block{n}-se-expand"] = _Conv(s, e)
            self[f"backbone-block{n}-project"] = _ConvBN(e, cout)
            cin = cout
        self["backbone-block16-expand"] = _ConvBN(cin, 960)

    def forward(self, x):
        x = hard_swish(self["backbone-block0-expand"](x))
        expanded, cin = {}, 16
        for n, (_, e, cout, se, hs, stride) in enumerate(BNECK, 1):
            act = hard_swish if hs else F.relu
            y = x
            if e != cin:
                y = expanded[n] = act(self[f"backbone-block{n}-expand"](x))
            y = act(self[f"backbone-block{n}-depthwise"](y))
            if se:
                s = F.relu(self[f"backbone-block{n}-se-reduce"](y.mean(dim=(2, 3), keepdim=True)))
                y = y * hard_sigmoid(self[f"backbone-block{n}-se-expand"](s))
            y = self[f"backbone-block{n}-project"](y)
            x = x + y if stride == 1 and cin == cout else y
            cin = cout
        return expanded[13], hard_swish(self["backbone-block16-expand"](x)), expanded[4]
