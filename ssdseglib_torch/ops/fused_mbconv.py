"""Fused stride-1 inverted-residual (MBConv) inference block.

Counterpart of ``ssdseglib_tpu/ops/fused_mbconv.py``.  A whole stride-1
block -- expand 1x1 -> relu6 -> depthwise 3x3 -> relu6 -> project 1x1
(-> + residual) -- runs as one hand-written Hopper kernel
(``csrc/fused_mbconv.cu``) that keeps the E-wide expanded tensor on chip,
so per pixel only Cin + Cout channels cross device memory instead of
Cin + 2E + Cout.  In bfloat16 the kernel walks E in chunks with both 1x1s
on the tensor cores and the next chunk's weights copied asynchronously; in
float32 it keeps the whole expanded tile and runs the 1x1s on the CUDA
cores.  bfloat16 needs Cin and Cout multiples of 8, E a multiple of 16 and
16-byte aligned operands; a call outside that raises.

BatchNorm is folded into conv weight + bias beforehand (`fold_conv_bn`).

``fused_mbconv`` calls the dispatcher op ``torch.ops.ssdseglib.fused_mbconv``
(so ``torch.export`` records it as one node), whose CUDA implementation
launches the kernel and whose CPU implementation is the plain twin
``fused_mbconv_reference``; a CUDA call the kernel cannot take raises.
``fused_mbconv.launches`` counts kernel launches, from a live call or from
inside an exported program alike.

On a mesh that splits the rows (`parallel/spatial.py`), `fused_mbconv_rows`
runs the block on this rank's WINDOW: its own rows plus one real row of each
neighbour at an inner edge and none past the global border.  The kernel pads
the window's edges with zero *expanded* values, which is the SAME padding at
the global border; at an inner edge it gets only the halo row's own output
wrong, and that row is dropped.  So the kernel runs unchanged, at one row of
extra work an inner edge, and x is never padded where the expanded tensor
must be (a zero row of x expands to relu6(b_expand), not to 0).
``fused_mbconv.window_launches`` counts those kernel launches (of
``fused_mbconv.launches``) that ran on windows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ssdseglib_torch.parallel import spatial

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BN_EPSILON = 1e-3  # the blocks' BatchNorm epsilon (models/blocks.py)


def fold_conv_bn(kernel, gamma, beta, mean, var, eps: float = BN_EPSILON):
    """Fold BatchNorm(scale, bias, mean, var) into (kernel', bias').

    ``kernel`` is a PyTorch conv weight, output channels first
    (O, I, kh, kw).  conv -> BN == conv with kernel * (gamma / sqrt(var +
    eps)) per output channel and bias (beta - mean * gamma / sqrt(var +
    eps)).  NumPy in f32, the same arithmetic as the JAX package's fold.
    """
    scale = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    kernel = np.asarray(kernel) * scale.reshape((-1,) + (1,) * (np.ndim(kernel) - 1))
    bias = np.asarray(beta) - np.asarray(mean) * scale
    return kernel.astype(np.float32), bias.astype(np.float32)


def _check(x, w1, b1, wd, b2, w3, b3, residual):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    e = w1.shape[-1]
    cout = w3.shape[-1]
    shapes = {
        "w_expand": (w1, (cin, e)), "b_expand": (b1, (e,)),
        "w_depthwise": (wd, (9, e)), "b_depthwise": (b2, (e,)),
        "w_project": (w3, (e, cout)), "b_project": (b3, (cout,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, H, W, Cin) tensor")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} is not supported (float32, bfloat16)")
    if residual and cin != cout:
        raise ValueError("residual requires Cin == Cout")


def _as_kernel_args(x, w_expand, w_depthwise, w_project):
    cin = x.shape[-1]
    w1 = w_expand.reshape(cin, -1)
    e = w1.shape[1]
    return w1, w_depthwise.reshape(9, e), w_project.reshape(e, -1)


def fused_mbconv(
    x: torch.Tensor,
    w_expand: torch.Tensor,
    b_expand: torch.Tensor,
    w_depthwise: torch.Tensor,
    b_depthwise: torch.Tensor,
    w_project: torch.Tensor,
    b_project: torch.Tensor,
    residual: bool = True,
) -> torch.Tensor:
    """Fused stride-1 inverted-residual block.

    Args:
        x: (B, H, W, Cin) NHWC, contiguous, float32 or bfloat16
        w_expand: (Cin, E) or (1, 1, Cin, E) folded expand weight
        b_expand: (E,)
        w_depthwise: (9, E) or (3, 3, 1, E) folded depthwise taps
        b_depthwise: (E,)
        w_project: (E, Cout) or (1, 1, E, Cout)
        b_project: (Cout,)
        residual: add the input (requires Cin == Cout)
    Every weight and bias is in x's dtype and on x's device.
    Returns:
        (B, H, W, Cout) in x's dtype.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
    w1, wd, w3 = _as_kernel_args(x, w_expand, w_depthwise, w_project)
    return torch.ops.ssdseglib.fused_mbconv(
        x, w1, b_expand, wd, b_depthwise, w3, b_project, residual)


fused_mbconv.launches = 0
fused_mbconv.window_launches = 0


def fused_mbconv_rows(x: torch.Tensor, *args, residual: bool = True) -> torch.Tensor:
    """`fused_mbconv` on the NCHW map ``x`` in the channels-last memory
    format (its NHWC view is then free), returned as a channels-last NCHW
    view; ``args`` are `fused_mbconv`'s weights.  On split rows the block
    runs on this rank's window (`parallel.spatial.edge_window` with one row
    each side) and the window's halo rows' outputs are dropped."""
    window = spatial.edge_window(x, 1, 1)
    if window is None:
        return fused_mbconv(x.permute(0, 2, 3, 1).contiguous(), *args,
                            residual=residual).permute(0, 3, 1, 2)
    launched = fused_mbconv.launches
    y = fused_mbconv(window.rows.permute(0, 2, 3, 1).contiguous(), *args, residual=residual)
    fused_mbconv.window_launches += fused_mbconv.launches - launched
    return y[:, window.top:y.shape[1] - window.bottom].permute(0, 3, 1, 2)


def _cuda_op(x, w1, b1, wd, b2, w3, b3, residual):
    _check(x, w1, b1, wd, b2, w3, b3, residual)
    out = _launch(x, w1, b1, wd, b2, w3, b3, residual)
    fused_mbconv.launches += 1
    return out


def _cpu_op(x, w1, b1, wd, b2, w3, b3, residual):
    _check(x, w1, b1, wd, b2, w3, b3, residual)
    return fused_mbconv_reference(x, w1, b1, wd, b2, w3, b3, residual)


def _fake_op(x, w1, b1, wd, b2, w3, b3, residual):
    _check(x, w1, b1, wd, b2, w3, b3, residual)
    return x.new_empty((*x.shape[:-1], w3.shape[-1]))


_LIBRARY = torch.library.Library("ssdseglib", "FRAGMENT")
_LIBRARY.define(
    "fused_mbconv(Tensor x, Tensor w_expand, Tensor b_expand, Tensor w_depthwise, "
    "Tensor b_depthwise, Tensor w_project, Tensor b_project, bool residual) -> Tensor")
_LIBRARY.impl("fused_mbconv", _cuda_op, "CUDA")
_LIBRARY.impl("fused_mbconv", _cpu_op, "CPU")
torch.library.register_fake("ssdseglib::fused_mbconv", _fake_op, lib=_LIBRARY)


def _launch(x, w1, b1, wd, b2, w3, b3, residual, config=(0, 0, 0, 0)):
    """One launch on the card.  ``config`` = (th, tw, EC, NREP) of the bf16
    kernel, 0 for the built-in choice (what `kernel_tile` reports); the
    f32 kernel ignores it."""
    from ssdseglib_torch.ops._cuda_build import load_library

    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
    ptrs = [t.data_ptr() for t in (x, w1, b1, wd, b2, w3, b3)]
    if x.dtype == torch.bfloat16 and any(p % 16 for p in ptrs):
        raise ValueError("fused_mbconv: bfloat16 operands must be 16-byte aligned")
    lib = load_library()
    batch, h, w, cin = x.shape
    e, cout = w1.shape[1], w3.shape[1]
    device = x.device
    out = torch.empty((batch, h, w, cout), dtype=x.dtype, device=device)
    args = (_DTYPE_CODES[x.dtype], *ptrs, out.data_ptr(), batch, h, w, cin, e, cout,
            int(residual), *config, torch.cuda.current_stream(device).cuda_stream)
    if device.index == torch.cuda.current_device():
        err = lib.fused_mbconv_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.fused_mbconv_launch(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_mbconv kernel launch failed with cudaError {err} "
            f"(B={batch}, H={h}, W={w}, Cin={cin}, E={e}, Cout={cout}, "
            f"{x.dtype}, config {config})"
        )
    return out


def kernel_tile(dtype: torch.dtype, cin: int, expanded: int, cout: int):
    """What the kernel uses for these widths on the current card:
    (th, tw, EC, threads, shared-memory bytes) -- the spatial tile, the
    chunk of E it walks (E itself for float32, whose kernel keeps the whole
    expanded tile), the CTA's threads and its dynamic shared memory."""
    from ssdseglib_torch.ops._cuda_build import load_library

    fields = [ctypes.c_int(0) for _ in range(5)]
    err = load_library().fused_mbconv_tile(
        _DTYPE_CODES[dtype], cin, expanded, cout, *(ctypes.byref(f) for f in fields)
    )
    if err != 0:
        raise RuntimeError(
            f"no tile for Cin={cin}, E={expanded}, Cout={cout}, {dtype}: cudaError {err}")
    return tuple(f.value for f in fields)


def fused_mbconv_reference(
    x, w_expand, b_expand, w_depthwise, b_depthwise, w_project, b_project,
    residual: bool = True, k_groups: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, with the same rounding points:
    f32 accumulation, rounding to x's dtype after expand + bias, after
    depthwise + bias and after project + bias, then the residual added in
    x's dtype.  Same arguments as `fused_mbconv`.

    With ``k_groups`` the two 1x1 products sum in the bf16 kernel's order
    (csrc/fused_mbconv.cu): the K axis in 16-deep steps taken in k order,
    each one mma.sync step into the running f32 accumulator
    (`s2d_stem.tensor_core_step` with ``acc``, the H100's step), from 0 --
    the project's steps run on across the chunks of E -- and the bias added
    to the finished sum, as the kernel's expand and its epilogue add it."""
    w1, wd, w3 = _as_kernel_args(x, w_expand, w_depthwise, w_project)
    dt, f32 = x.dtype, torch.float32
    batch, h, w, cin = x.shape
    e = w1.shape[1]

    def product(a, weight):
        if not k_groups:
            return a.to(f32) @ weight.to(f32)
        from ssdseglib_torch.ops.s2d_stem import tensor_core_step

        acc = torch.zeros((a.shape[0], weight.shape[1]), dtype=f32, device=a.device)
        for k0 in range(0, a.shape[1], 16):
            acc = tensor_core_step(a[:, k0:k0 + 16], weight[k0:k0 + 16], acc)
        return acc

    expanded = product(x.reshape(-1, cin), w1) + b_expand.to(f32)
    expanded = expanded.to(dt).clamp(0.0, 6.0).reshape(batch, h, w, e)
    padded = F.pad(expanded, (0, 0, 1, 1, 1, 1))  # zero halo of the expanded tensor
    taps = wd.to(f32)
    d = torch.zeros((batch, h, w, e), dtype=f32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            d = d + padded[:, dy:dy + h, dx:dx + w, :].to(f32) * taps[dy * 3 + dx]
    d = (d + b_depthwise.to(f32)).to(dt).clamp(0.0, 6.0)
    out = (product(d.reshape(-1, e), w3) + b_project.to(f32)).to(dt)
    out = out.reshape(batch, h, w, -1)
    return out + x if residual else out
