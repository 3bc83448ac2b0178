"""Shift-multiply depthwise convolution, counterpart of
``ssdseglib_tpu/ops/depthwise.py``.

A depthwise KxK conv does K*K multiply-adds an element: elementwise work,
not matrix work.  This formulation replaces the grouped conv by K*K shifted
slices of the padded input, each multiplied by its tap and added in f32;
autograd of the formulation gives the shifted multiply-adds of the input
gradient and plain multiply-reduces for the weight gradient.  The JAX
package kept it as an opt-in study (it lost on the TPU); on the card it is
the same trade, the library's grouped conv against 2 K*K elementwise
launches a layer, and `chip_smoke.py` phase 16 (b) times it
(`models.blocks.set_depthwise_impl("shift")`).

Numerics: products and tap sums in f32, the output cast back to the input's
dtype.  The SAME geometry is TF/XLA's (`parallel.spatial.same_pad`: for a
stride-2 window on an even size, 0 before and 1 after).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ssdseglib_torch.parallel.spatial import same_pad

Padding = Union[str, Sequence[Tuple[int, int]]]


def depthwise_conv_shift(
    x: torch.Tensor,
    kernel: torch.Tensor,
    strides: Tuple[int, int] = (1, 1),
    dilation: Tuple[int, int] = (1, 1),
    padding: Padding = "SAME",
) -> torch.Tensor:
    """Depthwise conv as K*K shifted multiply-adds.

    Args:
        x: (B, C, H, W)
        kernel: (C, 1, kh, kw), the weight of ``nn.Conv2d(groups=C)``
        padding: 'SAME' (TF geometry), 'VALID', or the explicit
            ((top, bottom), (left, right)) of a caller that pads a window
            of rows itself (`models.blocks.depthwise_conv` on split rows)
    Returns:
        (B, C, out_h, out_w) in x's dtype.
    """
    c, _, kh, kw = kernel.shape
    if x.shape[1] != c:
        raise ValueError(f"x has {x.shape[1]} channels, the kernel {c}")
    sh, sw = strides
    dh, dw = dilation
    b, _, h, w = x.shape
    eff_kh, eff_kw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    if padding == "SAME":
        (pt, pb), (pl, pr) = same_pad(h, kh, sh, dh), same_pad(w, kw, sw, dw)
    elif padding == "VALID":
        (pt, pb), (pl, pr) = (0, 0), (0, 0)
    elif isinstance(padding, str):
        raise ValueError(padding)
    else:
        (pt, pb), (pl, pr) = padding
    out_h = (h + pt + pb - eff_kh) // sh + 1
    out_w = (w + pl + pr - eff_kw) // sw + 1

    xp = F.pad(x, (pl, pr, pt, pb))
    taps = kernel.float().reshape(c, kh, kw)
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, :, i * dh:i * dh + (out_h - 1) * sh + 1:sh,
                     j * dw:j * dw + (out_w - 1) * sw + 1:sw]
            term = tap.float() * taps[:, i, j].view(1, c, 1, 1)
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)
