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

Under data parallelism (a ``group`` of ranks, each holding a slice of the
batch; ``parallel/mesh.py``) the statistics and the two BatchNorm sums are
those of the global batch, so the cross-rank sum falls between the passes:
the split path launches pass 1 alone (the rank's dbeta and dgamma), all-
reduces them on the stream, and launches pass 2 on the global sums and the
global pixel count.  The returned dgamma and dbeta stay the rank's own: the
step's gradient all-reduce averages them.

``dw_bn_relu6_backward`` launches the kernels on CUDA tensors and runs the
plain version ``dw_bn_relu6_backward_reference`` on CPU tensors; a CUDA call
the kernels cannot take raises.  ``dw_bn_relu6_backward.launches`` counts the
calls that reached the two-launch path, ``.split_launches`` those that
reached the split path.  ``dw_bn_relu6_chain`` is the autograd unit the model
uses.

On a mesh that splits the rows (`parallel/spatial.py`) the unit runs on this
rank's window: x with one halo row each side (`parallel.spatial.
window_rows`), u over the window, the statistics over the rank's own rows and
the whole mesh (the data group for a map that stays whole), and in the
backward dy padded by a zero row at each end and du confined to the own rows
(``rows``, the kernel's valid-row range): du = A dz - Bc - D xhat is nonzero
where dz is zero, so the zero rows of dy alone would not do.  dx covers the
window; its halo rows go back to their owners through the halo's backward.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssdseglib_torch.ops.depthwise_backward import (
    _DTYPE_CODES,
    _weight_grad,
    check_nhwc_operands,
    nhwc_view,
)
from ssdseglib_torch.parallel.mesh import all_reduce_, global_moments
from ssdseglib_torch.parallel.spatial import split_group, window_rows

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
    group: Optional[dist.ProcessGroup] = None,
    rows: Optional[Tuple[int, int]] = None,
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
        group: the group whose global batch mean and var are the
            statistics of (the split path), or None.
        rows: (lo, hi), the rows of a window whose du is computed (the
            rank's own rows; dy must be zero outside them), or None for
            every row.  The split path takes it; the pixel count is that of
            the rows.
    Returns:
        dx like x; dk (3, 3, 1, C), dgamma (C,), dbeta (C,) in f32; under a
        group, dgamma and dbeta are this rank's sums.
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
    if rows is not None and not 0 <= rows[0] < rows[1] <= h:
        raise ValueError(f"dw_bn_relu6_backward: rows {rows} outside the {h} rows")
    if x.device.type == "cpu":
        return dw_bn_relu6_backward_reference(x, u, dy, kernel, gamma, beta, mean, var,
                                              coefficients, group, rows)
    if x.device.type != "cuda":
        raise ValueError(f"dw_bn_relu6_backward runs on cuda or cpu, not {x.device}")
    if any(t.data_ptr() % 16 for t in (x, u, dy)):
        raise ValueError("dw_bn_relu6_backward: x, u and dy must be 16-byte aligned")
    if kernel.stride(0) != 3 * kernel.stride(1):
        kernel = kernel.contiguous()
    if group is None and rows is None:
        dx, dk, sums = _launch(x, u, dy, kernel, coefficients)
        dw_bn_relu6_backward.launches += 1
    else:
        dx, dk, sums = _launch_split(x, u, dy, kernel, coefficients, group, rows=rows)
        dw_bn_relu6_backward.split_launches += 1
    return dx, dk.reshape(3, 3, 1, c), sums[1], sums[0]


dw_bn_relu6_backward.launches = 0
dw_bn_relu6_backward.split_launches = 0


def _call(device, launch) -> int:
    """``launch()`` with ``device`` current."""
    if device.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(device):
        return launch()


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

    err = _call(device, launch)
    if err != 0:
        raise RuntimeError(
            f"chain backward kernel launch failed with cudaError {err} "
            f"(B, H, W, C = {dims}, {x.dtype}, config {tuple(config)})"
        )
    return dx, dk, sums


def _launch_split(x, u, dy, kernel, coefficients, group, config=BUILT_IN, rows=None):
    """The split path on checked CUDA operands: pass 1 writes this rank's
    (dbeta, dgamma); their all_reduce over ``group`` (None: no other rank)
    runs on the stream; pass 2 takes the global sums and the global pixel
    count (the ranks' shards are equal), du on ``rows`` (lo, hi) of the map
    only (None: every row).  Counts nothing.  Returns (dx, dk (9, C), this
    rank's sums (2, C))."""
    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    device = x.device
    dims = tuple(x.shape)
    code = _DTYPE_CODES[x.dtype]
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch, counters = _scratch(lib, device, stream, code, dims, tuple(config))
    sums_dk = torch.empty((13, dims[3]), dtype=torch.float32, device=device)
    dx, dk, sums, total = torch.empty_like(x), sums_dk[4:], sums_dk[:2], sums_dk[2:4]
    coef = [t.data_ptr() for t in coefficients]
    err = _call(device, lambda: lib.chain_backward_sums(
        code, u.data_ptr(), dy.data_ptr(), *coef, sums.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), *dims, stream))
    if err != 0:
        raise RuntimeError(f"chain backward pass 1 launch failed with cudaError {err} "
                           f"(B, H, W, C = {dims}, {x.dtype})")
    total.copy_(sums)
    lo, hi = rows or (0, dims[1])
    n_total = dims[0] * (hi - lo) * dims[2]
    if group is not None:
        all_reduce_(total, group)
        n_total *= dist.get_world_size(group)
    err = _call(device, lambda: lib.chain_backward_apply(
        code, x.data_ptr(), u.data_ptr(), dy.data_ptr(), kernel.data_ptr(),
        _DTYPE_CODES[kernel.dtype], kernel.stride(1), kernel.stride(3), *coef,
        total.data_ptr(), n_total, dx.data_ptr(), dk.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), *dims, *config, lo, hi, stream))
    if err != 0:
        raise RuntimeError(f"chain backward pass 2 launch failed with cudaError {err} "
                           f"(B, H, W, C = {dims}, {x.dtype}, config {tuple(config)})")
    return dx, dk, sums


def _dz_xhat(u, dy, coefficients):
    """dz and xhat in f32, the mask's rounding point the forward's."""
    mean32, inv, a_coef, beta32 = coefficients
    d = u.float() - mean32
    z = (d * a_coef + beta32).to(u.dtype).float()
    dz = torch.where((z > 0.0) & (z <= 6.0), dy.float(), torch.zeros((), device=u.device))
    return dz, d * inv


def chain_sums_reference(u, dy, coefficients) -> torch.Tensor:
    """Pass 1's plain version: (dbeta, dgamma) = (sum dz, sum dz * xhat) over
    the pixels of NHWC ``u`` and ``dy``, (2, C) f32."""
    dz, xhat = _dz_xhat(u, dy, coefficients)
    return torch.stack([dz.sum(dim=(0, 1, 2)), (dz * xhat).sum(dim=(0, 1, 2))])


def chain_apply_reference(x, u, dy, kernel, coefficients, totals, n: float, rows=None):
    """Pass 2's plain version: (dx, dk (3, 3, 1, C)) from the sums ``totals``
    (2, C) = (dbeta, dgamma) over ``n`` pixels (the global batch's, on a
    mesh), du zero outside the image and outside ``rows`` (lo, hi) of the
    map (None: every row), dx rounded once."""
    batch, h, w, c = x.shape
    _, _, a_coef, _ = coefficients
    dz, xhat = _dz_xhat(u, dy, coefficients)
    du = a_coef * dz - a_coef * (totals[0] / n) - (a_coef * (totals[1] / n)) * xhat
    if rows is not None:
        valid = torch.zeros((1, h, 1, 1), dtype=torch.bool, device=x.device)
        valid[:, rows[0]:rows[1]] = True
        du = torch.where(valid, du, torch.zeros((), device=x.device))
    k = kernel.float().reshape(3, 3, c)
    g = F.pad(du, (0, 0, 1, 1, 1, 1))
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dk = []
    for i in range(3):
        for j in range(3):
            dx = dx + k[i, j] * g[:, 2 - i:2 - i + h, 2 - j:2 - j + w]
            dk.append((xp[:, i:i + h, j:j + w] * du).sum(dim=(0, 1, 2)))
    return dx.to(x.dtype), torch.stack(dk).reshape(3, 3, 1, c)


def dw_bn_relu6_backward_reference(x, u, dy, kernel, gamma, beta, mean, var,
                                   coefficients=None, group=None, rows=None):
    """Plain PyTorch version of the kernels, with the same rounding points:
    z in f32 by Flax's association, cast to the I/O dtype and compared there;
    everything else f32; du zero outside the image (it is the correlation's
    padding there) and outside ``rows``; dx rounded once.  Pass 1
    (`chain_sums_reference`), then, under a ``group``, the split path's
    all_reduce of the sums and the global pixel count, then pass 2
    (`chain_apply_reference`).  Same arguments and results as
    `dw_bn_relu6_backward`."""
    batch, h, w, c = x.shape
    lo, hi = rows or (0, h)
    n = float(batch * (hi - lo) * w)
    if coefficients is None:
        coefficients = _coefficients(gamma, beta, mean, var)
    sums = chain_sums_reference(u, dy, coefficients)
    totals = sums
    if group is not None:
        totals = all_reduce_(sums.clone(), group)
        n *= dist.get_world_size(group)
    dx, dk = chain_apply_reference(x, u, dy, kernel, coefficients, totals, n, rows)
    return dx, dk, sums[1], sums[0]


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


def _stats(u32: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flax `_compute_stats` semantics over an f32 NCHW tensor: fast
    variance E[u^2] - E[u]^2, clipped at 0; over the global batch of a
    data-parallel ``group`` when one is given."""
    if group is not None:
        return global_moments(u32, group, u32.numel() // u32.shape[1] * dist.get_world_size(group))
    mean = u32.mean(dim=(0, 2, 3))
    var = ((u32 * u32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    return mean, var


def _forward_math(x, weight, gamma, beta, group=None, window: bool = False):
    """(y, u, mean, var, coefficients): the coefficients (mean, inv, A,
    beta) are the f32 tensors z was computed with.  With ``window``, x is a
    window with one halo row each side: u covers the window, y and the
    statistics the rows between."""
    u = F.conv2d(x, weight, None, 1, 1, 1, x.shape[1])
    u32 = (u[:, :, 1:-1] if window else u).float()
    mean, var = _stats(u32, group)
    coefficients = _coefficients(gamma, beta, mean, var)
    mean32, _, a_coef, beta32 = coefficients
    shape = (1, -1, 1, 1)
    z = ((u32 - mean32.view(shape)) * a_coef.view(shape) + beta32.view(shape)).to(u.dtype)
    return z.clamp(0.0, 6.0), u, mean, var, coefficients


class _DwBnRelu6Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, gamma, beta, group, window):
        y, u, mean, var, coefficients = _forward_math(x, weight, gamma, beta, group, window)
        ctx.save_for_backward(x, u, weight, gamma, beta, mean, var, *coefficients)
        ctx.mark_non_differentiable(mean, var)
        ctx.group, ctx.window = group, window
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, u, weight, gamma, beta, mean, var, *coefficients = ctx.saved_tensors
        counter = dw_bn_relu6_chain
        dy = nhwc_view(dy, counter)
        rows = None
        if ctx.window:  # the window's rows: a zero row of dy at each end
            dy, rows = F.pad(dy, (0, 0, 0, 0, 1, 1)), (1, dy.shape[1] + 1)
        dx, dk, dgamma, dbeta = dw_bn_relu6_backward(
            nhwc_view(x, counter), nhwc_view(u, counter), dy,
            weight.permute(2, 3, 1, 0), gamma, beta, mean, var, tuple(coefficients),
            ctx.group, rows,
        )
        return (
            dx.permute(0, 3, 1, 2),
            _weight_grad(dk, weight),
            dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype),
            None,
            None,
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
        Inside a `parallel.mesh.data_parallel` scope they are those of the
        global batch, and the backward takes the split path; on split rows
        the unit runs on this rank's window (module docstring).
    """
    if tuple(weight.shape) != (x.shape[1], 1, 3, 3):
        raise ValueError(
            f"weight has shape {tuple(weight.shape)}, expected ({x.shape[1]}, 1, 3, 3)"
        )
    group = split_group(x)
    x, padding = window_rows(x, 3, 1, 1)
    return _DwBnRelu6Chain.apply(x, weight, gamma, beta, group, padding == (0, 0))


dw_bn_relu6_chain.copies = 0
