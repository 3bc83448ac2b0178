"""Fused backward of a SAME stride-1 3x3 depthwise convolution.

Counterpart of ``ssdseglib_tpu/ops/depthwise_backward.py``.  Both gradients
come from one pass over x and dy, in one launch of a hand-written Hopper
kernel (``csrc/depthwise_backward.cu``):

    dx[t,w,c] = sum_{i,j} k[i,j,c] * dy[t+1-i, w+1-j, c]
    dk[i,j,c] = sum_{b,t,w} x[t+i-1, w+j-1, c] * dy[t,w,c]

with f32 products and sums, dk summed across the kernel's CTAs in an order
fixed by its grid (the same bits on every run).  The library route
(ATen/cuDNN) runs two more convolutions for the same result.

``depthwise3x3_backward`` launches the kernel on CUDA tensors and runs the
plain version ``depthwise3x3_backward_reference`` on CPU tensors; a CUDA call
the kernel cannot take raises.  ``depthwise3x3_backward.launches`` counts the
calls that reached the kernel.  ``depthwise_conv3x3_fused_bwd`` is the
autograd unit the model uses: its forward is the plain convolution.

On a mesh that splits the rows (`parallel/spatial.py`) the unit's forward
is the convolution on this rank's window (`parallel.spatial.window_rows`:
one halo row each side, fill 0 past the global border) with no row padding,
and its backward pads dy with one zero row at each end of the window: the
kernel's SAME backward over the window is then exactly this rank's share --
dx over the window (the halo rows' gradients go back to their owners), dk
from the own output rows (summed over the mesh by the step's gradient mean).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ssdseglib_torch.parallel import spatial

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
        kernel: (3, 3, 1, C) HWIO depthwise kernel on x's device; on the card
            read in place when it is f32 or bf16 and its two tap axes flatten
            (a contiguous kernel, or the HWIO view of a (C, 1, 3, 3) weight),
            else copied.
    Returns:
        dx with x's shape and dtype, dk (3, 3, 1, C) in f32.
    """
    check_nhwc_operands("depthwise3x3_backward", x, dy)
    c = x.shape[3]
    if tuple(kernel.shape) != (3, 3, 1, c):
        raise ValueError(f"kernel has shape {tuple(kernel.shape)}, expected (3, 3, 1, {c})")
    if kernel.device != x.device:
        raise ValueError(f"depthwise3x3_backward: kernel on {kernel.device}, x on {x.device}")
    if x.device.type == "cpu":
        return depthwise3x3_backward_reference(x, dy, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3_backward runs on cuda or cpu, not {x.device}")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("depthwise3x3_backward: x and dy must be 16-byte aligned")
    if kernel.dtype not in _DTYPE_CODES or kernel.stride(0) != 3 * kernel.stride(1):
        kernel = kernel.float().contiguous()
    dx, dk = _launch(x, dy, kernel)
    depthwise3x3_backward.launches += 1
    return dx, dk.reshape(3, 3, 1, c)


depthwise3x3_backward.launches = 0

# Scratch of the launch, allocated once per (device, stream, dtype, shape,
# config) and kept: (f32 partial sums, int32 counters, CTAs a chunk).  Sharing
# it between calls is safe because a buffer is only used on its own stream,
# where launches run in order, and every launch leaves the counters at 0.
_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, int]] = {}
# (tile rows, tile columns, channels of a chunk); 0 takes the source's
BUILT_IN = (0, 0, 0)


def kernel_geometry(lib, code: int, dims, config=BUILT_IN):
    """(scratch floats, counters, (tile rows, tile columns, chunk, CTAs a
    chunk, shared bytes a CTA)) of a launch on the current device."""
    floats, counters, geo = ctypes.c_longlong(0), ctypes.c_int(0), (ctypes.c_int * 5)()
    err = lib.depthwise_backward_scratch(code, *dims, *config, ctypes.byref(floats),
                                         ctypes.byref(counters), geo)
    if err != 0:
        raise RuntimeError(f"depthwise backward: no tiling for {dims} {config}: cudaError {err}")
    return floats.value, counters.value, tuple(geo)


def _launch(x, dy, kernel, config=BUILT_IN, out=None):
    """The launch on checked CUDA operands with (tile rows, tile columns,
    chunk) ``config``; counts nothing.  Returns (dx, dk (9, C)), into ``out``
    when given."""
    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    device = x.device
    dims = tuple(x.shape)
    code = _DTYPE_CODES[x.dtype]
    # the current stream's raw handle, without building a torch.cuda.Stream
    # object on every call's host path
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if out is None:
        out = (torch.empty_like(x), torch.empty((9, dims[3]), dtype=torch.float32, device=device))
    dx, dk = out

    def launch():
        key = (device.index, stream, code, dims, tuple(config))
        if key not in _SCRATCH:
            floats, counters, geo = kernel_geometry(lib, code, dims, config)
            # counters start at 0, and every launch leaves them at 0
            _SCRATCH[key] = (torch.empty(floats, dtype=torch.float32, device=device),
                             torch.zeros(counters, dtype=torch.int32, device=device), geo[3])
        scratch, counters, ctas = _SCRATCH[key]
        return lib.depthwise_backward_launch(
            code, x.data_ptr(), dy.data_ptr(), kernel.data_ptr(), _DTYPE_CODES[kernel.dtype],
            kernel.stride(1), kernel.stride(3), dx.data_ptr(), dk.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), *dims, *config, ctas, stream,
        )

    if device.index == torch.cuda.current_device():
        err = launch()
    else:  # the geometry and the kernel's attributes are the device's own
        with torch.cuda.device(device):
            err = launch()
    if err != 0:
        raise RuntimeError(
            f"depthwise backward kernel launch failed with cudaError {err} "
            f"(B, H, W, C = {dims}, {x.dtype}, config {tuple(config)})"
        )
    return dx, dk


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
    def forward(ctx, x, weight, window):
        ctx.save_for_backward(x, weight)
        ctx.window = window
        return F.conv2d(x, weight, None, 1, (0, 1) if window else 1, 1, x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        counter = depthwise_conv3x3_fused_bwd
        dy = nhwc_view(dy, counter)
        if ctx.window:  # the window's rows: a zero row at each end
            dy = F.pad(dy, (0, 0, 0, 0, 1, 1))
        dx, dk = depthwise3x3_backward(nhwc_view(x, counter), dy, weight.permute(2, 3, 1, 0))
        return dx.permute(0, 3, 1, 2), _weight_grad(dk, weight), None


def depthwise_conv3x3_fused_bwd(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 depthwise conv whose backward is the fused kernel.

    The forward IS the plain convolution, so it is bit-identical to it; only
    the gradients take another route (same f32 accumulation, another order
    of summation).

    Args:
        x: (B, C, H, W), this rank's rows on split rows (module
            docstring); the kernel reads it in place when it is in the
            channels-last memory format, else a copy is made and counted on
            ``depthwise_conv3x3_fused_bwd.copies``.
        weight: (C, 1, 3, 3) depthwise conv weight in x's dtype.
    """
    if tuple(weight.shape) != (x.shape[1], 1, 3, 3):
        raise ValueError(
            f"weight has shape {tuple(weight.shape)}, expected ({x.shape[1]}, 1, 3, 3)"
        )
    x, padding = spatial.window_rows(x, 3, 1, 1)
    return _DepthwiseConv3x3FusedBwd.apply(x, weight, padding == (0, 0))


depthwise_conv3x3_fused_bwd.copies = 0
