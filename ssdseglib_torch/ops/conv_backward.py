"""Weight-gradient routes for the training convolutions, counterpart of
``ssdseglib_tpu/ops/conv_backward.py``.

`conv2d_fast_wgrad` is a SAME convolution whose forward IS the library's
(`conv2d_same`, bit for bit) and whose input gradient (and bias gradient) is
the library's too (``aten.convolution_backward`` with the weight left out of
its output mask).  Only the weight gradient of **1x1 stride-1 dense convs**
(the MobileNetV2 expand/project layers, every separable conv's pointwise, the
ASPP and decoder pointwise reductions) takes another route:

    impl="dot"   one giant-K matrix product  x.reshape(-1, Ci)^T @ g.reshape(-1, Co)
                 (K = B*H*W) with f32 accumulation and an f32 result, left to
                 the library as the JAX package leaves it to XLA
    impl="cuda"  the hand-written split-K kernels of ``ops/pointwise_wgrad``
                 (tensor cores in bf16, CUDA cores in f32) inside
                 `wgrad_applicable`, which write the gradient in the weight's
                 (Co, Ci) layout and dtype in one launch; outside it the
                 library's rule

Every other conv (k > 1, strided, dilated with k > 1, grouped) keeps the
library's rule whatever ``impl`` says: the JAX package measured a per-tap
formulation for them and dropped it, and its gate is kept here.

The same contraction with f32 accumulation, cast to the weight's dtype at
the end: not a change of numerics beyond the order of summation.  The kernels
read the NHWC views of channels-last operands in place; a copy, if one is
ever needed, is counted on ``conv2d_fast_wgrad.copies``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ssdseglib_torch.models.blocks import conv2d_same, same_pad
from ssdseglib_torch.ops.depthwise_backward import nhwc_view
from ssdseglib_torch.ops.pointwise_wgrad import dot_wgrad, pointwise_wgrad, wgrad_applicable

IMPLS = ("dot", "cuda")


def reformulated(weight: torch.Tensor, stride: int, groups: int) -> bool:
    """The JAX package's gate: only 1x1, stride 1, groups 1 take another
    weight-gradient route."""
    return tuple(weight.shape[2:]) == (1, 1) and stride == 1 and groups == 1


def own_route(weight: torch.Tensor, stride: int, groups: int, impl: str,
              dtype: torch.dtype) -> bool:
    """Whether ``impl`` gives this conv's weight gradient another route than
    the library's: every reformulated conv under "dot", those inside the
    kernels' envelope under "cuda"."""
    co, ci = weight.shape[:2]
    return reformulated(weight, stride, groups) and (
        impl == "dot" or wgrad_applicable(ci, co, dtype))


def _library_backward(g, x, weight, has_bias, stride, dilation, groups, mask):
    """``aten.convolution_backward`` of `conv2d_same`: (dx, dw, db), None
    where ``mask`` is False."""
    (top, bottom) = same_pad(x.shape[2], weight.shape[2], stride, dilation)
    (left, right) = same_pad(x.shape[3], weight.shape[3], stride, dilation)
    symmetric = top == bottom and left == right
    xin = x if symmetric else F.pad(x, (left, right, top, bottom))
    padding = [top, left] if symmetric else [0, 0]
    dx, dw, db = torch.ops.aten.convolution_backward(
        g, xin, weight, [weight.shape[0]] if has_bias else None, [stride, stride], padding,
        [dilation, dilation], False, [0, 0], groups, list(mask))
    if mask[0] and not symmetric:
        dx = dx[:, :, top:top + x.shape[2], left:left + x.shape[3]]
    return (dx if mask[0] else None, dw if mask[1] else None, db if mask[2] else None)


class _Conv2dFastWgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, dilation, groups, impl):
        ctx.save_for_backward(x, weight)
        ctx.conv = (bias is not None, stride, dilation, groups, impl)
        return conv2d_same(x, weight, bias, stride, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        has_bias, stride, dilation, groups, impl = ctx.conv
        need_x, need_w, need_b = (ctx.needs_input_grad[i] for i in range(3))
        co, ci = weight.shape[:2]
        own = need_w and own_route(weight, stride, groups, impl, x.dtype)
        dx, dw, db = _library_backward(
            g, x, weight, has_bias, stride, dilation, groups,
            (need_x, need_w and not own, has_bias and need_b))
        if own:
            counter = conv2d_fast_wgrad
            xv, gv = nhwc_view(x, counter), nhwc_view(g, counter)
            if impl == "dot":
                dk = dot_wgrad(xv, gv)  # (Ci, Co) f32
                dw = torch.empty_like(weight)  # the weight's dtype and strides
                dw.copy_(dk.t().reshape(co, ci, 1, 1))
            else:
                # (Co, Ci) in the weight's dtype, written so by the kernel: the
                # memory of a (Co, Ci, 1, 1) weight in either memory format
                dw = pointwise_wgrad(xv, gv, weight.dtype).as_strided(
                    weight.shape, weight.stride())
        return dx, dw, db, None, None, None, None


def conv2d_fast_wgrad(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, stride: int = 1, dilation: int = 1,
                      groups: int = 1, impl: str = "dot") -> torch.Tensor:
    """SAME convolution with the weight gradient of 1x1 stride-1 dense convs
    rerouted (see the module docstring).  Forward and input gradient are
    bit-identical to `conv2d_same`.

    Args:
        x: (B, Ci, H, W); the kernels read it in place when it is in the
            channels-last memory format.
        weight: (Co, Ci / groups, kh, kw) in x's dtype.
        bias: (Co,) or None.
        impl: "dot" or "cuda".
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return _Conv2dFastWgrad.apply(x, weight, bias, stride, dilation, groups, impl)


conv2d_fast_wgrad.copies = 0
