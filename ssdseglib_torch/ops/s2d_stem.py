"""Fused MobileNetV2 stem + first inverted-residual block.

Counterpart of ``ssdseglib_tpu/ops/s2d_stem.py``.  The stem (3x3 stride-2
conv 3 -> 32, depthwise 3x3, 1x1 32 -> 16) and block 1 (1x1 16 -> 96,
depthwise 3x3 stride 2, 1x1 96 -> 24) run as one hand-written Hopper kernel
(``csrc/s2d_stem.cu``) that keeps all five intermediates on chip: device
memory sees the image read and the (H/4, W/4, 24) output write.  In bf16 its
four products run on the tensor cores and block 1's 96 channels are walked
in chunks; f32 runs on the CUDA cores.

The JAX package's kernel first re-indexes the image by space-to-depth and
packs four images into one vector, both answers to its hardware's vector
width; neither is part of the function and neither is ported.  The kernel
here takes plain NHWC images and the six folded convs.

BatchNorm is folded into conv weight + bias beforehand
(``ops/fused_mbconv.fold_conv_bn``); `stem_block1_args` turns the six folded
OIHW convs into the kernel's layouts once.

``fused_stem_block1`` launches the kernel on a CUDA tensor and runs the
plain version ``fused_stem_block1_reference`` on a CPU tensor; a CUDA call
the kernel cannot take raises.  ``fused_stem_block1.launches`` counts kernel
launches.  `kernel_config` reports the bf16 kernel's tile and chunk.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (weight shape, bias shape) of the six convs in the kernel's layouts
_SHAPES = (
    ((27, 32), (32,)),  # stem 3x3 s2, rows ordered (dy, dx, cin)
    ((9, 32), (32,)),   # stem depthwise taps, row-major
    ((32, 16), (16,)),  # stem project
    ((16, 96), (96,)),  # block-1 expand
    ((9, 96), (96,)),   # block-1 depthwise s2 taps
    ((96, 24), (24,)),  # block-1 project
)
_NAMES = tuple(
    f"backbone-block{block}-{stage}"
    for block in (0, 1) for stage in ("expand", "depthwise", "project")
)


def stem_block1_args(
    folded: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]
) -> Tuple[torch.Tensor, ...]:
    """The kernel's twelve arguments (weight, bias of the six convs, in
    order) from the folded OIHW convs keyed ``backbone-block{0,1}-{expand,
    depthwise,project}``."""
    args = []
    for name, (w_shape, _) in zip(_NAMES, _SHAPES):
        kernel, bias = folded[name]
        # OIHW -> (kh, kw, I, O) flattened to (kh * kw * I, O)
        args += [kernel.permute(2, 3, 1, 0).reshape(w_shape).contiguous(), bias.contiguous()]
    return tuple(args)


def _check(images: torch.Tensor, folded: Sequence[torch.Tensor]) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got shape {tuple(images.shape)}")
    if images.shape[1] % 4 != 0 or images.shape[2] % 4 != 0 or images.shape[1] < 4 \
            or images.shape[2] < 4:
        raise ValueError(
            f"H and W must be positive multiples of 4, got {tuple(images.shape[1:3])}"
        )
    if images.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {images.dtype} is not supported (float32, bfloat16)")
    if not images.is_contiguous():
        raise ValueError("images must be a contiguous (B, H, W, 3) tensor")
    if len(folded) != 12:
        raise ValueError(f"folded must hold 12 tensors (stem_block1_args), got {len(folded)}")
    shapes = [s for pair in _SHAPES for s in pair]
    for i, (t, shape) in enumerate(zip(folded, shapes)):
        name = f"{_NAMES[i // 2]} {'bias' if i % 2 else 'weight'}"
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != images.dtype or t.device != images.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; images are {images.dtype} "
                f"on {images.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_stem_block1(images: torch.Tensor, folded: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stem + block 1 of MobileNetV2, BN folded.

    Args:
        images: (B, H, W, 3) NHWC, contiguous, already rescaled to [-1, 1],
            float32 or bfloat16; H and W multiples of 4
        folded: the twelve tensors of `stem_block1_args`, in the images'
            dtype and on their device (16-byte aligned on the card)
    Returns:
        the block-1 output (B, H/4, W/4, 24) in the images' dtype.
    """
    _check(images, folded)
    if images.device.type == "cpu":
        return fused_stem_block1_reference(images, folded)
    out = _launch(images, folded)
    fused_stem_block1.launches += 1
    return out


fused_stem_block1.launches = 0

# (output tile rows, columns at H/4, chunk of block 1's 96 channels, warps) of
# the bf16 kernel; 0 takes the source's choice
BUILT_IN = (0, 0, 0, 0)


def _launch(images: torch.Tensor, folded: Sequence[torch.Tensor],
            config: Tuple[int, int, int, int] = BUILT_IN) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors that passed `_check`, with
    the bf16 kernel's ``config`` (ignored in f32); counts nothing."""
    if images.device.type != "cuda":
        raise ValueError(f"fused_stem_block1 runs on cuda or cpu, not {images.device}")
    if images.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (images, *folded)):
        raise ValueError("fused_stem_block1: bf16 images and weights must be 16-byte "
                         "aligned (stem_block1_args makes the weights so)")

    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    batch, h, w, _ = images.shape
    out = torch.empty((batch, h // 4, w // 4, 24), dtype=images.dtype, device=images.device)
    if batch == 0:
        return out
    with torch.cuda.device(images.device):
        err = lib.stem_block1_launch(
            _DTYPE_CODES[images.dtype], images.data_ptr(),
            *(t.data_ptr() for t in folded), out.data_ptr(), batch, h, w, *config,
            torch.cuda.current_stream(images.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"stem + block 1 kernel launch failed with cudaError {err} "
            f"(B={batch}, H={h}, W={w}, {images.dtype}, config {config})"
        )
    return out


def kernel_config(h: int, w: int, config: Tuple[int, int, int, int] = BUILT_IN
                  ) -> Tuple[int, ...]:
    """What the bf16 kernel runs at (H, W) under ``config`` (0: the source's
    choice), on the current card: (tile rows, tile columns, chunk, warps,
    bytes of shared memory)."""
    import ctypes

    from ssdseglib_torch.ops._cuda_build import load_library

    values = [ctypes.c_int(v) for v in config] + [ctypes.c_int(0)]
    err = load_library().stem_block1_config(h, w, *(ctypes.byref(v) for v in values))
    if err != 0:
        raise RuntimeError(f"no bf16 stem configuration for H={h}, W={w}, {config}: "
                           f"cudaError {err}")
    return tuple(v.value for v in values)


def _round_relu6(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).clamp(0.0, 6.0)


def _depthwise3x3(x: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """f32 sum of the nine taps (row-major order) of a SAME 3x3 depthwise
    conv over NHWC ``x`` of even height and width: padding 1 and 1 at stride
    1, 0 before and 1 after at stride 2."""
    _, h, w, _ = x.shape
    before = 1 if stride == 1 else 0
    padded = F.pad(x, (0, 0, before, 1, before, 1)).float()
    ho, wo = h // stride, w // stride
    taps = taps.float()
    acc = torch.zeros((x.shape[0], ho, wo, x.shape[3]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            window = padded[:, dy:dy + stride * ho:stride, dx:dx + stride * wo:stride]
            acc = acc + window * taps[dy * 3 + dx]
    return acc


def tensor_core_step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, k) @ w (k, O), k <= 16, as one step of the bf16 kernel's tensor
    cores (mma.sync m16n8k16 into a zero accumulator): the products are
    exact and their sum is rounded toward zero to f32.  This model of the
    H100's step is what `chip_smoke.py` phase 3c holds the kernel to."""
    exact = x.double() @ w.double()
    rounded = exact.float()
    return torch.where(rounded.double().abs() > exact.abs(),
                       torch.nextafter(rounded, torch.zeros_like(rounded)), rounded)


def fused_stem_block1_reference(
    images: torch.Tensor, folded: Sequence[torch.Tensor], k_groups: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same six rounding
    points: f32 accumulation, rounding to the images' dtype after each conv
    + bias (before its ReLU6).  Same arguments as `fused_stem_block1`.

    With ``k_groups`` the four matrix products sum in the bf16 kernel's
    order: each 16-deep group of the K axis as one partial
    (`tensor_core_step`), the partials added in k order to an f32 sum that
    starts at 0, then the bias."""
    w1, b1, wd1, bd1, wp1, bp1, w2, b2, wd2, bd2, wp2, bp2 = folded
    dt = images.dtype
    batch, h, w, _ = images.shape
    h2, w2dim = h // 2, w // 2

    def pointwise(x, weight, bias):
        x2 = x.reshape(-1, x.shape[-1]).float()
        if k_groups:
            y = torch.zeros((x2.shape[0], weight.shape[1]), dtype=torch.float32,
                            device=x.device)
            for k0 in range(0, x2.shape[1], 16):
                y = y + tensor_core_step(x2[:, k0:k0 + 16], weight[k0:k0 + 16])
            y = y + bias.float()
        else:
            y = x2 @ weight.float() + bias.float()
        return y.reshape(*x.shape[:-1], -1)

    # stem conv: SAME at stride 2 pads 0 before and 1 after; output (r, c)
    # reads rows 2r .. 2r+2.  Patches ordered (dy, dx, cin), like w1's rows.
    padded = F.pad(images, (0, 0, 0, 1, 0, 1))
    patches = torch.cat(
        [padded[:, dy:dy + 2 * h2:2, dx:dx + 2 * w2dim:2]
         for dy in range(3) for dx in range(3)],
        dim=-1,
    )
    e = _round_relu6(pointwise(patches, w1, b1), dt)
    d = _round_relu6(_depthwise3x3(e, wd1, 1) + bd1.float(), dt)
    p = pointwise(d, wp1, bp1).to(dt)
    e2 = _round_relu6(pointwise(p, w2, b2), dt)
    d2 = _round_relu6(_depthwise3x3(e2, wd2, 2) + bd2.float(), dt)
    return pointwise(d2, wp2, bp2).to(dt)
