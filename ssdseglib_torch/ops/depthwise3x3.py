"""Depthwise 3x3 convolution of the folded serving forward, its padding,
bias and activation inside one launch.

No Pallas original: the JAX package leaves these convolutions to XLA, which
fuses the padding, the bias and the activation into the convolution.  Eager
PyTorch runs them as cuDNN's grouped convolution, an ``F.pad`` copy for each
stride-2 convolution on an even size (SAME pads it 0 before and 1 after),
the bias add and the clamp, each a pass over device memory.  On the card
the function is one hand-written Hopper kernel (``csrc/depthwise3x3.cu``),
which reads the activation once, takes zeros for the pads in its loads and
applies bias and activation in registers before its one store.  On the NHWC view
``x (B, H, W, C)`` of a channels-last activation, with explicit pads
``(top, bottom, left, right)``:

    y[b, ho, wo, c] = act(bias[c] + sum_{i,j} w[c, 0, i, j]
                                    * x[b, ho s - top + i d, wo s - left + j d, c])

x outside the map is zero; act is one of four: the identity,
clamp(0, relu_cap) (``relu_cap``), max(0, y) (``activation="relu"``) or the
h-swish y relu6(y + 3) / 6 (``activation="hard_swish"``).  The kernel sums
and applies act in f32 and rounds once; it takes bfloat16 only, C a
multiple of 8.

``depthwise3x3`` calls the dispatcher op ``torch.ops.ssdseglib.depthwise3x3``
(so ``torch.export`` records it as one node), whose CUDA implementation
launches the kernel and whose CPU implementation is the plain version
``depthwise3x3_reference``, the library route: ``F.conv2d`` with groups C
(explicit padding only where it is asymmetric, as `models.blocks.
conv2d_same` pads), then the activation's library call.  A CUDA call the
kernel cannot take raises.  ``depthwise3x3.launches`` counts kernel launches, live or from
inside an exported program.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

VECTOR = 8  # channels of one 16-byte load of the kernel


def output_size(size: int, before: int, after: int, stride: int, dilation: int) -> int:
    """Outputs along one axis of ``size`` inputs padded ``before`` and
    ``after``."""
    return (size + before + after - 2 * dilation - 1) // stride + 1


def _act_code(relu_cap, activation) -> int:
    """The kernel's code of act (``csrc/depthwise3x3.cu``): 0 the identity,
    1 the clamp to [0, relu_cap], 2 "relu", 3 "hard_swish"; ValueError for
    another activation, or for one given with a relu_cap."""
    if activation is None:
        return 0 if relu_cap is None else 1
    if activation not in ("relu", "hard_swish") or relu_cap is not None:
        raise ValueError(f"activation must be None, 'relu' or 'hard_swish', with no relu_cap; "
                         f"got {activation!r} and relu_cap {relu_cap!r}")
    return 2 if activation == "relu" else 3


def _check(x, weight, bias, stride, dilation, pads, relu_cap=None, activation=None) -> int:
    """ValueError for what the op does not take; returns `_act_code`'s."""
    act = _act_code(relu_cap, activation)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"dtype {x.dtype} is not supported (bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (the NHWC view of a channels-last tensor)")
    c = x.shape[-1]
    if tuple(weight.shape) != (c, 1, 3, 3):
        raise ValueError(f"weight must be ({c}, 1, 3, 3), got {tuple(weight.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on {x.device}")
    if bias is not None and (tuple(bias.shape) != (c,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous ({c},), got {tuple(bias.shape)}")
    if stride not in (1, 2) or dilation < 1:
        raise ValueError(f"stride must be 1 or 2 and dilation positive, got {stride}, {dilation}")
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError(f"pads must be four non-negative (top, bottom, left, right), got {pads}")
    top, bottom, left, right = pads
    if min(output_size(x.shape[1], top, bottom, stride, dilation),
           output_size(x.shape[2], left, right, stride, dilation)) < 1:
        raise ValueError(f"no output for a {tuple(x.shape[1:3])} map with pads {tuple(pads)}")
    return act


def depthwise3x3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: int, dilation: int, pads: Sequence[int],
                 relu_cap: Optional[float] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """Depthwise 3x3 conv + bias (+ clamp to [0, relu_cap], or the named
    activation).

    Args:
        x: (B, H, W, C) NHWC, contiguous, bfloat16 (on the card: 16-byte
            aligned, C a multiple of 8)
        weight: (C, 1, 3, 3), the conv's weight, any strides
        bias: (C,) or None
        stride: 1 or 2; dilation: >= 1
        pads: (top, bottom, left, right) zero rows and columns around x
        relu_cap: None for no clamp, else the clamp's upper end
        activation: None, "relu" (uncapped) or "hard_swish"; with no
            relu_cap
    The weight and bias in x's dtype and on x's device.
    Returns:
        (B, Ho, Wo, C) in x's dtype.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"depthwise3x3 runs on cuda or cpu, not {x.device}")
    return torch.ops.ssdseglib.depthwise3x3(x, weight, bias, stride, dilation, list(pads),
                                            relu_cap, activation)


depthwise3x3.launches = 0


def depthwise3x3_reference(x, weight, bias, stride, dilation, pads, relu_cap=None,
                           activation=None):
    """Plain PyTorch version, the library route: ``F.conv2d`` with groups C on
    the channels-last NCHW view of ``x``, padded explicitly only where the
    pads are asymmetric, the bias inside the call, then the activation.  The
    same calls, in the same order, as `models.blocks.conv2d_same` followed
    by ``clamp(0, relu_cap)``, ``F.relu`` or ``F.hardswish``, so the same
    bits.  Same arguments as `depthwise3x3`."""
    top, bottom, left, right = pads
    nchw = x.permute(0, 3, 1, 2)
    groups = nchw.shape[1]
    if top == bottom and left == right:
        y = F.conv2d(nchw, weight, bias, stride, (top, left), dilation, groups)
    else:
        y = F.conv2d(F.pad(nchw, (left, right, top, bottom)), weight, bias, stride, 0,
                     dilation, groups)
    if relu_cap is not None:
        y = y.clamp(0.0, relu_cap)
    elif activation == "relu":
        y = F.relu(y)
    elif activation == "hard_swish":
        y = F.hardswish(y)
    return y.permute(0, 2, 3, 1).contiguous()


def _cuda_op(x, weight, bias, stride, dilation, pads, relu_cap, activation=None):
    act = _check(x, weight, bias, stride, dilation, pads, relu_cap, activation)
    out = _launch(x, weight, bias, stride, dilation, pads, relu_cap, act)
    depthwise3x3.launches += 1
    return out


def _cpu_op(x, weight, bias, stride, dilation, pads, relu_cap, activation=None):
    _check(x, weight, bias, stride, dilation, pads, relu_cap, activation)
    return depthwise3x3_reference(x, weight, bias, stride, dilation, pads, relu_cap, activation)


def _fake_op(x, weight, bias, stride, dilation, pads, relu_cap, activation=None):
    _check(x, weight, bias, stride, dilation, pads, relu_cap, activation)
    top, bottom, left, right = pads
    return x.new_empty((x.shape[0], output_size(x.shape[1], top, bottom, stride, dilation),
                        output_size(x.shape[2], left, right, stride, dilation), x.shape[3]))


_LIBRARY = torch.library.Library("ssdseglib", "FRAGMENT")
_LIBRARY.define("depthwise3x3(Tensor x, Tensor weight, Tensor? bias, int stride, int dilation, "
                "int[] pads, float? relu_cap, str? activation=None) -> Tensor")
_LIBRARY.impl("depthwise3x3", _cuda_op, "CUDA")
_LIBRARY.impl("depthwise3x3", _cpu_op, "CPU")
torch.library.register_fake("ssdseglib::depthwise3x3", _fake_op, lib=_LIBRARY)


_kernel = None  # the library's depthwise3x3_launch, once loaded


def _launch(x, weight, bias, stride, dilation, pads, relu_cap, act=None):
    """One launch on CUDA tensors that passed `_check`, ``act`` the code it
    returned (None: the identity or the clamp, as ``relu_cap`` says);
    counts nothing."""
    global _kernel
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"depthwise3x3 runs on cuda or cpu, not {device}")
    c = x.shape[-1]
    if c % VECTOR or x.data_ptr() % 16:
        raise ValueError(f"depthwise3x3: C must be a multiple of {VECTOR} and x 16-byte "
                         f"aligned, got C={c}")
    if _kernel is None:
        from ssdseglib_torch.ops._cuda_build import load_library

        _kernel = load_library().depthwise3x3_launch
    top, bottom, left, right = pads
    batch, h, w = x.shape[:3]
    ho = output_size(h, top, bottom, stride, dilation)
    wo = output_size(w, left, right, stride, dilation)
    out = torch.empty((batch, ho, wo, c), dtype=x.dtype, device=device)
    kcs, _, kis, kjs = weight.stride()
    args = (x.data_ptr(), weight.data_ptr(), kcs, kis, kjs,
            None if bias is None else bias.data_ptr(), out.data_ptr(), batch, h, w, c, ho, wo,
            stride, dilation, top, left, _act_code(relu_cap, None) if act is None else act,
            0.0 if relu_cap is None else float(relu_cap),
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = _kernel(*args)
    else:
        with torch.cuda.device(device):
            err = _kernel(*args)
    if err != 0:
        raise RuntimeError(
            f"depthwise3x3 kernel launch failed with cudaError {err} (x {tuple(x.shape)}, "
            f"stride {stride}, dilation {dilation}, pads {tuple(pads)})")
    return out

