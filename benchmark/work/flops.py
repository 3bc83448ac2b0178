"""Convolution operations of one forward, from the configuration's shapes.

Every convolution of the reference network is traced on the meta device
(its weight and output shapes, nothing computed) and counted as 2 x the
multiply-adds its shapes require: 2 * outputs * (input channels / groups) *
kernel height * kernel width.  Pooling, resizes, softmaxes, BatchNorm and
elementwise work are left out (a few percent of the operations).  Training
counts 3 x the forward: the forward, the input gradients and the weight
gradients."""

from __future__ import annotations

from typing import Dict

from benchmark.reference.model import conv_shapes


def conv_flops(weight_shape, out_shape, groups: int) -> float:
    del groups  # weight_shape[1] is already input channels / groups
    n, cout, h, w = out_shape
    return 2.0 * n * cout * h * w * weight_shape[1] * weight_shape[2] * weight_shape[3]


def forward_flops_per_image(model: Dict) -> float:
    return sum(conv_flops(*s) for s in conv_shapes(model, batch=1))


def train_flops_per_image(model: Dict) -> float:
    return 3.0 * forward_flops_per_image(model)
