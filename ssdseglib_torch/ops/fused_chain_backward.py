"""Whole-chain fused backward of depthwise 3x3 + train-mode BatchNorm + ReLU6.

Counterpart of ``ssdseglib_tpu/ops/fused_chain_backward.py``.  The unit is
the model's ``DepthwiseConvBN`` in train mode:

    u    = depthwise3x3(x, k)                      # SAME, stride 1
    mean, var = batch statistics of u over (B, H, W)   # Flax: E[u^2] - E[u]^2
    z    = (u - mean) * (rsqrt(var + eps) * gamma) + beta, cast to u's dtype
    y    = min(relu(z), 6)

Backward, given dy (mean and var are functions of x in train mode):

    mask = (z > 0) & (z <= 6)          # gradient 0 at exactly 0, 1 at exactly 6
    dz   = dy * mask
    dbeta = sum(dz);  dgamma = sum(dz * xhat)
    du   = gamma/sigma * (dz - dbeta/N - xhat * dgamma/N)
    dx   = corr3x3(du, flip(k));  dk[i,j,c] = sum x * shift(du)

The two BatchNorm sums are a barrier, so the hand-written Hopper kernels
(``csrc/fused_chain_backward.cu``) make two passes, two launches and no other
device work: one that reduces dbeta and dgamma and ends with Bc and D, one
that reads x, u and dy once more and produces dx and dk with the mask, dz and
du living only in shared memory.  The backward takes the forward's own
(mean, inv, A, beta), so its mask is the forward's clip bit for bit.  The
library route (ATen/cuDNN autograd) runs a clamp backward, a BatchNorm
backward and two convolutions, each through device memory.

``dw_bn_relu6_backward`` launches the kernels on CUDA tensors and runs the
plain version ``dw_bn_relu6_backward_reference`` on CPU tensors; a CUDA call
the kernels cannot take raises.  ``dw_bn_relu6_backward.launches`` counts the
calls that reached the kernels.  ``dw_bn_relu6_chain`` is the autograd unit
the model uses.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ssdseglib_torch.ops.depthwise_backward import (
    _DTYPE_CODES,
    _weight_grad,
    check_nhwc_operands,
    nhwc_view,
)

BN_EPSILON = 1e-3  # the blocks' BatchNorm epsilon (models/blocks.py)


def _check_channel_vectors(c: int, device, **vectors: torch.Tensor) -> None:
    for name, t in vectors.items():
        if tuple(t.shape) != (c,) or t.device != device:
            raise ValueError(
                f"dw_bn_relu6_backward: {name} is {tuple(t.shape)} on {t.device}, "
                f"expected ({c},) on {device}"
            )


def _coefficients(gamma, beta, mean, var):
    """(mean, inv, A = gamma * inv, beta) in f32, Flax's association."""
    inv = torch.rsqrt(var.float() + BN_EPSILON)
    return mean.float(), inv, gamma.float() * inv, beta.float()


# Scratch of the two launches, allocated once per (device, stream, dtype,
# shape, tile) and kept: (f32 values, int32 counters).  Sharing it between
# calls is safe because a buffer is only used on its own stream, where
# launches run in order, and every launch leaves the counters at 0.
_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
# (rows, columns) of pass 2's tile; 0 takes the source's
BUILT_IN = (0, 0)


def _scratch(lib, device, stream, code, dims, config) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream, code, dims, config)
    if key not in _SCRATCH:
        floats, counters = ctypes.c_longlong(0), ctypes.c_int(0)
        err = lib.chain_backward_scratch(code, *dims, *config, ctypes.byref(floats),
                                         ctypes.byref(counters))
        if err != 0:
            raise RuntimeError(f"chain backward: no tiling for {dims} {config}: cudaError {err}")
        # counters start at 0, and every launch leaves them at 0
        _SCRATCH[key] = (torch.empty(floats.value, dtype=torch.float32, device=device),
                         torch.zeros(counters.value, dtype=torch.int32, device=device))
    return _SCRATCH[key]


def _check_coefficients(c: int, device, coefficients) -> None:
    if len(coefficients) != 4:
        raise ValueError("dw_bn_relu6_backward: coefficients are (mean, inv, A, beta)")
    for name, t in zip(("mean", "inv", "A", "beta"), coefficients):
        if (tuple(t.shape) != (c,) or t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous()):
            raise ValueError(
                f"dw_bn_relu6_backward: coefficient {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, expected contiguous ({c},) float32 on {device}"
            )


def dw_bn_relu6_backward(
    x: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, kernel: torch.Tensor,
    gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
    coefficients: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (dx, dk, dgamma, dbeta) for the dw3x3 + BN(train) + ReLU6 chain.

    Args:
        x: (B, H, W, C) conv input, float32 or bfloat16.
        u: (B, H, W, C) conv output saved by the forward, like x.
        dy: (B, H, W, C) cotangent of the ReLU6 output, like x.
        kernel: (3, 3, 1, C) HWIO depthwise kernel, f32 or bf16; read in
            place when its two tap axes flatten (a contiguous kernel, or the
            HWIO view of a (C, 1, 3, 3) weight), else copied.
        gamma, beta: (C,) BatchNorm scale and offset.
        mean, var: (C,) batch statistics the forward normalised with.
        coefficients: the forward's (mean, inv, A = gamma * inv, beta), (C,)
            f32 each, as `_forward_math` returns them; computed from gamma,
            beta, mean and var when None.
    Returns:
        dx like x; dk (3, 3, 1, C), dgamma (C,), dbeta (C,) in f32.
    """
    check_nhwc_operands("dw_bn_relu6_backward", x, u, dy)
    batch, h, w, c = x.shape
    if tuple(kernel.shape) != (3, 3, 1, c):
        raise ValueError(f"kernel has shape {tuple(kernel.shape)}, expected (3, 3, 1, {c})")
    if kernel.dtype not in _DTYPE_CODES or kernel.device != x.device:
        raise ValueError(f"dw_bn_relu6_backward: kernel is {kernel.dtype} on {kernel.device}")
    _check_channel_vectors(c, x.device, gamma=gamma, beta=beta, mean=mean, var=var)
    if coefficients is None:
        coefficients = _coefficients(gamma, beta, mean, var)
    _check_coefficients(c, x.device, coefficients)
    if x.device.type == "cpu":
        return dw_bn_relu6_backward_reference(x, u, dy, kernel, gamma, beta, mean, var,
                                              coefficients)
    if x.device.type != "cuda":
        raise ValueError(f"dw_bn_relu6_backward runs on cuda or cpu, not {x.device}")
    if any(t.data_ptr() % 16 for t in (x, u, dy)):
        raise ValueError("dw_bn_relu6_backward: x, u and dy must be 16-byte aligned")
    if kernel.stride(0) != 3 * kernel.stride(1):
        kernel = kernel.contiguous()
    dx, dk, sums = _launch(x, u, dy, kernel, coefficients)
    dw_bn_relu6_backward.launches += 1
    return dx, dk.reshape(3, 3, 1, c), sums[1], sums[0]


dw_bn_relu6_backward.launches = 0


def _launch(x, u, dy, kernel, coefficients, config=BUILT_IN, out=None):
    """The two launches on checked CUDA operands, with pass 2's (tile rows,
    tile columns) ``config``; counts nothing.  Returns (dx, dk (9,
    C), sums (2, C) = (dbeta, dgamma)), into ``out`` when given."""
    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    device = x.device
    dims = tuple(x.shape)
    code = _DTYPE_CODES[x.dtype]
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch, counters = _scratch(lib, device, stream, code, dims, tuple(config))
    if out is None:
        sums_dk = torch.empty((11, dims[3]), dtype=torch.float32, device=device)
        out = (torch.empty_like(x), sums_dk[2:], sums_dk[:2])
    dx, dk, sums = out

    def launch():
        return lib.chain_backward_launch(
            code, x.data_ptr(), u.data_ptr(), dy.data_ptr(), kernel.data_ptr(),
            _DTYPE_CODES[kernel.dtype], kernel.stride(1), kernel.stride(3),
            *(t.data_ptr() for t in coefficients), dx.data_ptr(), dk.data_ptr(),
            sums.data_ptr(), scratch.data_ptr(), counters.data_ptr(), *dims, *config, stream,
        )

    if device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(device):
            err = launch()
    if err != 0:
        raise RuntimeError(
            f"chain backward kernel launch failed with cudaError {err} "
            f"(B, H, W, C = {dims}, {x.dtype}, config {tuple(config)})"
        )
    return dx, dk, sums


def dw_bn_relu6_backward_reference(x, u, dy, kernel, gamma, beta, mean, var,
                                   coefficients=None):
    """Plain PyTorch version of the kernels, with the same rounding points:
    z in f32 by Flax's association, cast to the I/O dtype and compared there;
    everything else f32; du zero outside the image (it is the correlation's
    padding there); dx rounded once.  Same arguments and results as
    `dw_bn_relu6_backward`."""
    batch, h, w, c = x.shape
    n = float(batch * h * w)
    if coefficients is None:
        coefficients = _coefficients(gamma, beta, mean, var)
    mean32, inv, a_coef, beta32 = coefficients
    d = u.float() - mean32
    z = (d * a_coef + beta32).to(u.dtype).float()
    dz = torch.where((z > 0.0) & (z <= 6.0), dy.float(), torch.zeros((), device=x.device))
    xhat = d * inv
    dbeta = dz.sum(dim=(0, 1, 2))
    dgamma = (dz * xhat).sum(dim=(0, 1, 2))
    du = a_coef * dz - a_coef * (dbeta / n) - (a_coef * (dgamma / n)) * xhat

    k = kernel.float().reshape(3, 3, c)
    g = F.pad(du, (0, 0, 1, 1, 1, 1))
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dk = []
    for i in range(3):
        for j in range(3):
            dx = dx + k[i, j] * g[:, 2 - i:2 - i + h, 2 - j:2 - j + w]
            dk.append((xp[:, i:i + h, j:j + w] * du).sum(dim=(0, 1, 2)))
    return dx.to(x.dtype), torch.stack(dk).reshape(3, 3, 1, c), dgamma, dbeta


def chain_applicable(h: int, w: int, c: int, kernel_size, strides, dilation,
                     relu_max) -> bool:
    """Where the model routes a DepthwiseConvBN through the chain: the JAX
    package's envelope plus the chain's own requirement (ReLU6 present).
    The TPU kernel's two row-tile terms are Mosaic tiling rules and have no
    counterpart here.  A performance heuristic, not a bound of the kernel."""
    return (
        tuple(kernel_size) == (3, 3)
        and tuple(strides) == (1, 1)
        and tuple(dilation) == (1, 1)
        and relu_max == 6.0
        and c <= 64
        and h * w * c >= 1_000_000
    )


def _stats(u32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flax `_compute_stats` semantics over an f32 NCHW tensor: fast
    variance E[u^2] - E[u]^2, clipped at 0."""
    mean = u32.mean(dim=(0, 2, 3))
    var = ((u32 * u32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    return mean, var


def _forward_math(x, weight, gamma, beta):
    """(y, u, mean, var, coefficients): the coefficients (mean, inv, A,
    beta) are the f32 tensors z was computed with."""
    u = F.conv2d(x, weight, None, 1, 1, 1, x.shape[1])
    u32 = u.float()
    mean, var = _stats(u32)
    coefficients = _coefficients(gamma, beta, mean, var)
    mean32, _, a_coef, beta32 = coefficients
    shape = (1, -1, 1, 1)
    z = ((u32 - mean32.view(shape)) * a_coef.view(shape) + beta32.view(shape)).to(u.dtype)
    return z.clamp(0.0, 6.0), u, mean, var, coefficients


class _DwBnRelu6Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, gamma, beta):
        y, u, mean, var, coefficients = _forward_math(x, weight, gamma, beta)
        ctx.save_for_backward(x, u, weight, gamma, beta, mean, var, *coefficients)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, u, weight, gamma, beta, mean, var, *coefficients = ctx.saved_tensors
        counter = dw_bn_relu6_chain
        dx, dk, dgamma, dbeta = dw_bn_relu6_backward(
            nhwc_view(x, counter), nhwc_view(u, counter), nhwc_view(dy, counter),
            weight.permute(2, 3, 1, 0), gamma, beta, mean, var, tuple(coefficients),
        )
        return (
            dx.permute(0, 3, 1, 2),
            _weight_grad(dk, weight),
            dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype),
        )


def dw_bn_relu6_chain(x, weight, gamma, beta):
    """dw3x3(SAME, s1) -> train-mode BatchNorm -> ReLU6 as one autograd unit
    whose backward is the fused kernel.

    Args:
        x: (B, C, H, W); the kernel reads it in place when it is in the
            channels-last memory format, else a copy is made and counted on
            ``dw_bn_relu6_chain.copies``.
        weight: (C, 1, 3, 3) depthwise conv weight in x's dtype.
        gamma, beta: (C,) BatchNorm scale and offset.
    Returns:
        (y, batch_mean, batch_var).  The statistics are f32, not
        differentiable, and exist for the caller's running-average update.
    """
    if tuple(weight.shape) != (x.shape[1], 1, 3, 3):
        raise ValueError(
            f"weight has shape {tuple(weight.shape)}, expected ({x.shape[1]}, 1, 3, 3)"
        )
    return _DwBnRelu6Chain.apply(x, weight, gamma, beta)


dw_bn_relu6_chain.copies = 0
