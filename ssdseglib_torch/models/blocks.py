"""Primitive conv blocks (PyTorch), counterpart of ssdseglib_tpu/models/blocks.py.

conv -> batchnorm -> (capped) relu, the depthwise variant, and the
Keras-style SeparableConv (depthwise then pointwise, batchnorm after the
pointwise only), plus ShuffleNetV2's channel shuffle and max pool.  Every
conv and pool pads TF/XLA "SAME" (`conv2d_same`, `max_pool_same`): for a
stride-2 window on an even size that is 0 before and 1 after, which torch's
symmetric ``padding=`` cannot express.

Tensors are NCHW in the channels-last memory format.  Module and parameter
names mirror the Flax tree ("conv", "batchnorm", "depthwise", "pointwise"),
so ``weights.py`` bridges the two by a rename plus a transpose.

Activation convention (``relu_max``): None = no activation, 0.0 = uncapped
ReLU, x > 0 = ReLU capped at x.  ``activation`` names the two hard
activations of MobileNetV3 instead (Howard et al., 2019, section 5.2):
'hard_swish' ``x * relu6(x + 3) / 6`` and 'hard_sigmoid' ``relu6(x + 3) / 6``;
`squeeze_excite` is its squeeze-and-excitation (section 5.3).

Train mode follows Flax: `FlaxBatchNorm2d` keeps the BIASED batch variance in
``running_var``; inside a `parallel.mesh.data_parallel` scope its statistics
are those of the global batch.  On a mesh whose spatial axis splits the rows,
the convs, the pool and the resize read and write the global map through
`parallel.spatial` (halo rows, global SAME padding, global resize
coordinates).  Three module-level gates, named as in the JAX package, choose
a backward route: of the depthwise layers inside the envelope
(`set_depthwise_bwd_impl`, `set_chain_bwd_impl`; on split rows their kernels
run on this rank's window of rows, and the envelope reads the global map)
and of the weight gradient of the dense convs (`set_wgrad_impl`); a fourth,
`set_depthwise_impl`, the depthwise convs' formulation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssdseglib_torch.parallel import spatial
from ssdseglib_torch.parallel.mesh import active_groups, all_reduce_, global_moments
from ssdseglib_torch.parallel.spatial import same_pad  # noqa: F401  (this module's name too)

BN_EPSILON = 1e-3
# torch's momentum weighs the new batch statistic: 1 - Flax's 0.99
BN_MOMENTUM = 0.01


# Depthwise convolution's formulation: 'conv' = the library's grouped conv;
# 'shift' = K*K shifted multiply-adds with autograd through them
# (ops/depthwise.py), the JAX package's study, which lost on the TPU and which
# chip_smoke.py phase 16 (b) times on the card.  'shift' takes precedence
# over DEPTHWISE_BWD_IMPL, as in the JAX package; the chain gate, read first
# in DepthwiseConvBN, over both.  Parameter names and shapes do not depend on
# it.  Read at every forward.
DEPTHWISE_IMPL = "conv"


def set_depthwise_impl(impl: str) -> None:
    global DEPTHWISE_IMPL
    if impl not in ("conv", "shift"):
        raise ValueError(f"depthwise impl must be 'conv' or 'shift', got {impl!r}")
    DEPTHWISE_IMPL = impl


# Depthwise BACKWARD route (the forward is the library's conv either way):
# 'aten' = the ATen/cuDNN autograd of the conv; 'cuda' routes stride-1 SAME
# 3x3 depthwise convs inside the envelope (ops/depthwise_backward.
# pallas_bwd_applicable -- in the flagship model that is block0-depthwise)
# through the hand-written one-pass dgrad + wgrad kernel.  Opt-in, as in the
# JAX package: a kernel becomes a default only after it wins on the card.
# Read at every forward.
DEPTHWISE_BWD_IMPL = "aten"


def set_depthwise_bwd_impl(impl: str) -> None:
    global DEPTHWISE_BWD_IMPL
    if impl not in ("aten", "cuda"):
        raise ValueError(
            f"depthwise bwd impl must be 'aten' or 'cuda', got {impl!r}"
        )
    DEPTHWISE_BWD_IMPL = impl


# Whole-CHAIN backward route for DepthwiseConvBN(+ReLU6) in train mode:
# 'cuda' routes the full dw3x3 + BN + ReLU6 unit (inside the envelope,
# ops/fused_chain_backward.chain_applicable) through one autograd unit whose
# backward is the hand-written fused kernel: mask + BN gradient chain + dgrad
# + wgrad with nothing of the chain written to device memory.  Opt-in.
# Read at every forward.
CHAIN_BWD_IMPL = "aten"


def set_chain_bwd_impl(impl: str) -> None:
    global CHAIN_BWD_IMPL
    if impl not in ("aten", "cuda"):
        raise ValueError(f"chain bwd impl must be 'aten' or 'cuda', got {impl!r}")
    CHAIN_BWD_IMPL = impl


# Weight-gradient route of every dense (groups = 1) model conv: 'aten' = the
# ATen/cuDNN autograd of the conv; 'dot' and 'cuda' route the conv through
# ops/conv_backward.conv2d_fast_wgrad, whose forward and input gradient stay
# the library's.  There the weight gradient of 1x1 stride-1 convs is one
# giant-K library product with an f32 result ('dot'), or the hand-written
# split-K kernels of ops/pointwise_wgrad inside their envelope
# (wgrad_applicable -- in the flagship model backbone-block0-project and
# backbone-block1-expand), the ATen rule outside it ('cuda').  A conv whose
# weight gradient keeps the library's rule under the gate is not routed
# through the unit at all: the unit's Python would cost host time per layer
# and change nothing.  Parameter names, shapes and forward values do not
# depend on the gate.  Opt-in.  Read at every forward.
WGRAD_IMPL = "aten"


def set_wgrad_impl(impl: str) -> None:
    global WGRAD_IMPL
    if impl not in ("aten", "dot", "cuda"):
        raise ValueError(f"wgrad impl must be 'aten', 'dot' or 'cuda', got {impl!r}")
    WGRAD_IMPL = impl


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with SAME padding of the global map (on split rows, the
    rows this rank's output reads: `parallel.spatial.window_rows`); pads
    explicitly only when the padding is asymmetric."""
    x, (top, bottom) = spatial.window_rows(x, weight.shape[2], stride, dilation)
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


# the hard activations by name: x * relu6(x + 3) / 6 and relu6(x + 3) / 6
HARD_ACTIVATIONS = {"hard_swish": F.hardswish, "hard_sigmoid": F.hardsigmoid}


def apply_activation(x: torch.Tensor, relu_max: Optional[float],
                     activation: Optional[str]) -> torch.Tensor:
    """``activation`` (a name of HARD_ACTIVATIONS) where given, else the
    ReLU of ``relu_max`` (`apply_relu`)."""
    if activation is None:
        return apply_relu(x, relu_max)
    return HARD_ACTIVATIONS[activation](x)


def _check_activation(relu_max: Optional[float], activation: Optional[str]) -> None:
    if activation is not None and (activation not in HARD_ACTIVATIONS or relu_max is not None):
        raise ValueError(f"activation must be one of {sorted(HARD_ACTIVATIONS)} with no "
                         f"relu_max, got {activation!r} and relu_max {relu_max!r}")


def squeeze_excite(x: torch.Tensor, reduce: nn.Conv2d, expand: nn.Conv2d) -> torch.Tensor:
    """MobileNetV3's squeeze-and-excitation: x scaled per channel by
    hard_sigmoid(expand(relu(reduce(mean of x over H x W)))), both 1x1 convs
    with their biases; the mean is the global map's on split rows."""
    s = F.relu(reduce(spatial.mean_hw(x)))
    return x * F.hardsigmoid(expand(s))


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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates ``running_var`` with the
    BIASED batch variance, as Flax's BatchNorm does (torch stores the
    unbiased one).  The library call does the normalisation and the update;
    the n/(n-1) factor is then taken out of the variance's increment:

        new_torch = (1 - m) * old + m * unbiased
        new_flax  = (1 - m) * old + m * unbiased * (n - 1) / n
                  = new_torch * (1 - 1/n) + old * (1 - m) / n

    ``num_batches_tracked`` is left alone in train mode: the momentum is
    fixed, nothing reads the count, and Flax has no counterpart.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        groups = active_groups()
        if groups is not None:
            return self._global_forward(x, groups)
        n = x.numel() // x.shape[1]
        # the library call keeps its running_var argument for the backward,
        # so it gets a working copy and the buffer is written afterwards
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(var, alpha=1.0 - 1.0 / n)
        return y

    def _global_forward(self, x: torch.Tensor, groups) -> torch.Tensor:
        """Train mode over the global batch (`_GlobalBatchNorm`): over every
        rank of the mesh for a map whose rows are split, over the data group
        for a whole one (its spatial copies are no samples).  The running
        statistics move by the global mean and the biased global variance."""
        group = spatial.split_group(x)
        count = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, group, count)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm whose statistics are those of the global batch.

    Forward: `global_moments` over ``group``, whose ranks hold ``count``
    values a channel together, then z = (x - mean) * (rsqrt(var + eps) *
    gamma) + beta in f32 (f64 for an f64 x; Flax's association), cast to x's
    dtype.  Backward, with N = count: one all_reduce of [sum dz,
    sum dz * xhat], then
    dx = gamma * inv * (dz - sum dz / N - xhat * sum(dz * xhat) / N).  dgamma
    and dbeta are this rank's sums: the gradient all-reduce of the step
    averages them with the other ranks' gradients."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group, count):
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        x32 = x.to(wide)
        mean, var = global_moments(x32, group, count)
        inv = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        y = ((x32 - mean.view(shape)) * (inv * gamma.to(wide)).view(shape)
             + beta.to(wide).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.group, ctx.count = group, float(count)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * inv.view(shape)
        dz = dy.to(mean.dtype)
        local = torch.stack([dz.sum(dim=(0, 2, 3)), (dz * xhat).sum(dim=(0, 2, 3))])
        total = all_reduce_(local.clone(), ctx.group) / ctx.count
        dx = (gamma.to(mean.dtype) * inv).view(shape) * (
            dz - total[0].view(shape) - xhat * total[1].view(shape))
        return (dx.to(dy.dtype), local[1].to(gamma.dtype), local[0].to(gamma.dtype),
                None, None, None)


def batchnorm(channels: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(channels, eps=BN_EPSILON, momentum=BN_MOMENTUM)


def depthwise_conv(conv: "SameConv2d", x: torch.Tensor) -> torch.Tensor:
    """A depthwise `SameConv2d` applied through the selected formulation
    (DEPTHWISE_IMPL) and backward route (DEPTHWISE_BWD_IMPL).  The shift
    formulation pads as `conv2d_same` does: on split rows it takes the same
    window of rows (`parallel.spatial.window_rows`)."""
    if DEPTHWISE_IMPL == "shift":
        from ssdseglib_torch.ops.depthwise import depthwise_conv_shift

        (kh, kw), (sh, sw), (dh, dw) = conv.kernel_size, conv.stride, conv.dilation
        x, rows = spatial.window_rows(x, kh, sh, dh)
        cols = same_pad(x.shape[3], kw, sw, dw)
        return depthwise_conv_shift(x, conv.weight, conv.stride, conv.dilation, (rows, cols))
    if DEPTHWISE_BWD_IMPL == "cuda":
        from ssdseglib_torch.ops.depthwise_backward import (
            depthwise_conv3x3_fused_bwd,
            pallas_bwd_applicable,
        )

        # the envelope reads the global map: a shard routes where one process does
        h, w = spatial.global_size(x)
        if pallas_bwd_applicable(h, w, x.shape[1], conv.kernel_size, conv.stride,
                                 conv.dilation):
            return depthwise_conv3x3_fused_bwd(x, conv.weight)
    return conv(x)


def dense_conv(conv: "SameConv2d", x: torch.Tensor) -> torch.Tensor:
    """A dense (groups = 1) `SameConv2d` applied through the selected
    weight-gradient route (WGRAD_IMPL)."""
    if WGRAD_IMPL == "aten":
        return conv(x)
    from ssdseglib_torch.ops.conv_backward import conv2d_fast_wgrad, own_route

    if not own_route(conv.weight, conv.stride[0], conv.groups, WGRAD_IMPL, x.dtype):
        return conv(x)
    return conv2d_fast_wgrad(x, conv.weight, conv.bias, conv.stride[0], conv.dilation[0],
                             conv.groups, impl=WGRAD_IMPL)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with SAME padding; no bias unless asked for (the
    ShuffleNetV2 stem conv has one)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = False) -> None:
        super().__init__(cin, cout, kernel_size, stride=stride, dilation=dilation,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, self.stride[0],
                           self.dilation[0], self.groups)


class ConvBN(nn.Module):
    """Pointwise/standard conv -> batchnorm -> optional capped relu or hard
    activation."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 strides: int = 1, dilation: int = 1,
                 relu_max: Optional[float] = None, activation: Optional[str] = None) -> None:
        super().__init__()
        _check_activation(relu_max, activation)
        self.conv = SameConv2d(cin, features, kernel_size, strides, dilation)
        self.batchnorm = batchnorm(features)
        self.relu_max, self.activation = relu_max, activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_activation(self.batchnorm(dense_conv(self.conv, x)), self.relu_max,
                                self.activation)


class DepthwiseConvBN(nn.Module):
    """Depthwise conv (one filter per channel) -> batchnorm -> optional relu
    or hard activation."""

    def __init__(self, channels: int, kernel_size: int = 3, strides: int = 1,
                 dilation: int = 1, relu_max: Optional[float] = None,
                 activation: Optional[str] = None) -> None:
        super().__init__()
        _check_activation(relu_max, activation)
        self.conv = SameConv2d(channels, channels, kernel_size, strides, dilation,
                               groups=channels)
        self.batchnorm = batchnorm(channels)
        self.relu_max, self.activation = relu_max, activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and CHAIN_BWD_IMPL == "cuda" and self.activation is None:
            from ssdseglib_torch.ops.fused_chain_backward import chain_applicable

            # the envelope reads the global map: a shard routes where one process does
            h, w = spatial.global_size(x)
            if chain_applicable(h, w, x.shape[1], self.conv.kernel_size, self.conv.stride,
                                self.conv.dilation, self.relu_max):
                return self._fused_chain(x)
        x = depthwise_conv(self.conv, x)
        return apply_activation(self.batchnorm(x), self.relu_max, self.activation)

    def _fused_chain(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode forward through the whole-chain autograd unit
        (ops/fused_chain_backward.dw_bn_relu6_chain), on the same parameters
        and buffers as the plain branch; the running-average update of
        `FlaxBatchNorm2d` is done here."""
        from ssdseglib_torch.ops.fused_chain_backward import dw_bn_relu6_chain

        bn = self.batchnorm
        y, mean, var = dw_bn_relu6_chain(x, self.conv.weight, bn.weight, bn.bias)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        return y


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
        x = dense_conv(self.pointwise, depthwise_conv(self.depthwise, x))
        return apply_relu(self.batchnorm(x), self.relu_max)


def max_pool_same(x: torch.Tensor, kernel_size: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool with SAME padding by -inf (Flax ``nn.max_pool(...,
    padding="SAME")``): at stride 2 on an even size, 0 before and 1 after,
    which ``F.max_pool2d``'s symmetric ``padding=`` cannot express.  On split
    rows, -inf at the global borders only (`parallel.spatial.window_rows`)."""
    x, (top, bottom) = spatial.window_rows(x, kernel_size, stride, 1, fill=float("-inf"))
    (left, right) = same_pad(x.shape[3], kernel_size, stride, 1)
    if top == bottom and left == right:
        return F.max_pool2d(x, kernel_size, stride, (top, left))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel_size, stride)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """ShuffleNet channel shuffle: output channel k is input channel
    ``(k % groups) * (C / groups) + k // groups``, as the JAX package's NHWC
    reshape / swap / reshape gives it.  Done on the NHWC view, so a
    channels-last input costs one copy and the result is channels-last."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups)
    return nhwc.transpose(3, 4).reshape(b, h, w, c).permute(0, 3, 1, 2)


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize to the global size (height, width) with half-pixel
    centers (``jax.image.resize`` 'bilinear' / ``tf.image.resize``); the
    serving path only upsamples, where no antialiasing applies.  On split
    rows, in global coordinates (`parallel.spatial.resize_bilinear`)."""
    return spatial.resize_bilinear(x, height, width)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Flax-default init of every conv in ``module`` from ``generator``
    (a conv bias starts at 0); BatchNorm keeps torch's defaults (scale 1,
    bias 0, mean 0, var 1), which are Flax's too."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
