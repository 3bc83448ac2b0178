"""Fused backward of a SAME stride-1 3x3 depthwise convolution.

Counterpart of ``ssdseglib_tpu/ops/depthwise_backward.py``.  Both gradients
come from one pass over x and dy, as one hand-written Hopper kernel
(``csrc/depthwise_backward.cu``):

    dx[t,w,c] = sum_{i,j} k[i,j,c] * dy[t+1-i, w+1-j, c]
    dk[i,j,c] = sum_{b,t,w} x[t+i-1, w+j-1, c] * dy[t,w,c]

with f32 products and sums.  The library route (ATen/cuDNN) runs two more
convolutions for the same result.

``depthwise3x3_backward`` launches the kernel on CUDA tensors and runs the
plain version ``depthwise3x3_backward_reference`` on CPU tensors; a CUDA call
the kernel cannot take raises.  ``depthwise3x3_backward.launches`` counts the
calls that reached the kernel.  ``depthwise_conv3x3_fused_bwd`` is the
autograd unit the model uses: its forward is the plain convolution.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_nhwc_operands(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """The kernels' input contract: (B, H, W, C) contiguous tensors of one
    shape, dtype (float32 or bfloat16) and device."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} is not supported (float32, bfloat16)")
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{name}: operands differ: {tuple(t.shape)} {t.dtype} on {t.device} "
                f"against {tuple(x.shape)} {x.dtype} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (B, H, W, C)")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor {tuple(x.shape)}")


def taps_f32(kernel: torch.Tensor, channels: int) -> torch.Tensor:
    """A (3, 3, 1, C) depthwise kernel as the (9, C) contiguous f32 table
    the kernels read (a copy of 9 * C values)."""
    if tuple(kernel.shape) != (3, 3, 1, channels):
        raise ValueError(
            f"kernel has shape {tuple(kernel.shape)}, expected (3, 3, 1, {channels})"
        )
    return kernel.reshape(9, channels).float().contiguous()


def nhwc_view(t: torch.Tensor, counter) -> torch.Tensor:
    """The (B, H, W, C) view of an NCHW tensor for the kernels: free when the
    tensor is in the channels-last memory format, else a copy, which is
    counted on ``counter.copies``."""
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        counter.copies += 1
        v = v.contiguous()
    return v


def _weight_grad(dk: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(3, 3, 1, C) f32 dk as the gradient of a (C, 1, 3, 3) conv weight: its
    dtype and its strides, so an optimizer's multi-tensor update sees the
    layout it sees from the library's route."""
    grad = torch.empty_like(weight)
    grad.copy_(dk.permute(3, 2, 0, 1))
    return grad


def depthwise3x3_backward(
    x: torch.Tensor, dy: torch.Tensor, kernel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (dx, dk) for a SAME stride-1 3x3 depthwise conv.

    Args:
        x: (B, H, W, C) input of the forward conv, float32 or bfloat16.
        dy: (B, H, W, C) cotangent of the forward output, like x.
        kernel: (3, 3, 1, C) HWIO depthwise kernel.
    Returns:
        dx with x's shape and dtype, dk (3, 3, 1, C) in f32.
    """
    check_nhwc_operands("depthwise3x3_backward", x, dy)
    batch, h, w, c = x.shape
    taps = taps_f32(kernel, c)
    if x.device.type == "cpu":
        return depthwise3x3_backward_reference(x, dy, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3_backward runs on cuda or cpu, not {x.device}")

    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    dx = torch.empty_like(x)
    dk = torch.empty((9, c), dtype=torch.float32, device=x.device)
    rows = lib.dw_bwd_partial_rows(batch, h, w, c)
    partials = torch.empty((rows, 9, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.depthwise_backward_launch(
            _DTYPE_CODES[x.dtype],
            *(t.data_ptr() for t in (x, dy, taps, dx, partials, dk)),
            batch, h, w, c, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"depthwise backward kernel launch failed with cudaError {err} "
            f"(B={batch}, H={h}, W={w}, C={c}, {x.dtype})"
        )
    depthwise3x3_backward.launches += 1
    return dx, dk.reshape(3, 3, 1, c)


depthwise3x3_backward.launches = 0


def depthwise3x3_backward_reference(
    x: torch.Tensor, dy: torch.Tensor, kernel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, written with shifts and sums:
    f32 arithmetic, dx rounded once to x's dtype, dk f32.  Same arguments and
    results as `depthwise3x3_backward`."""
    _, h, w, c = x.shape
    k = kernel.float().reshape(3, 3, c)
    g = F.pad(dy.float(), (0, 0, 1, 1, 1, 1))
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    centre = g[:, 1:1 + h, 1:1 + w]
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dk = []
    for i in range(3):
        for j in range(3):
            # dy[t+1-i, w+1-j] sits at padded index (t+2-i, w+2-j)
            dx = dx + k[i, j] * g[:, 2 - i:2 - i + h, 2 - j:2 - j + w]
            dk.append((xp[:, i:i + h, j:j + w] * centre).sum(dim=(0, 1, 2)))
    return dx.to(x.dtype), torch.stack(dk).reshape(3, 3, 1, c)


def pallas_bwd_applicable(h: int, w: int, c: int, kernel_size, strides,
                          dilation) -> bool:
    """Where the model routes a depthwise conv through the fused backward:
    the JAX package's envelope (stride-1 SAME 3x3, few channels, a spatial
    extent big enough to matter).  Its two row-tile terms are Mosaic tiling
    rules of the TPU kernel and have no counterpart here: the CUDA kernel
    takes any shape.  The envelope is a performance heuristic, not a bound
    of the kernel."""
    return (
        tuple(kernel_size) == (3, 3)
        and tuple(strides) == (1, 1)
        and tuple(dilation) == (1, 1)
        and c <= 64
        and h * w * c >= 1_000_000
    )


class _DepthwiseConv3x3FusedBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, None, 1, 1, 1, x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        counter = depthwise_conv3x3_fused_bwd
        dx, dk = depthwise3x3_backward(
            nhwc_view(x, counter), nhwc_view(dy, counter), weight.permute(2, 3, 1, 0)
        )
        return dx.permute(0, 3, 1, 2), _weight_grad(dk, weight)


def depthwise_conv3x3_fused_bwd(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 depthwise conv whose backward is the fused kernel.

    The forward IS the plain convolution, so it is bit-identical to it; only
    the gradients take another route (same f32 accumulation, another order
    of summation).

    Args:
        x: (B, C, H, W); the kernel reads it in place when it is in the
            channels-last memory format, else a copy is made and counted on
            ``depthwise_conv3x3_fused_bwd.copies``.
        weight: (C, 1, 3, 3) depthwise conv weight in x's dtype.
    """
    if tuple(weight.shape) != (x.shape[1], 1, 3, 3):
        raise ValueError(
            f"weight has shape {tuple(weight.shape)}, expected ({x.shape[1]}, 1, 3, 3)"
        )
    return _DepthwiseConv3x3FusedBwd.apply(x, weight)


depthwise_conv3x3_fused_bwd.copies = 0
