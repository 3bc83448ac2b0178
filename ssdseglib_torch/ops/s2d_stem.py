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
width; the kernel here takes plain NHWC images and the six folded convs.
The reformulation itself is ported as the JAX package's second study,
`s2d_stem_block1_xla`: the same function as library convs on the
space-to-depth image with four images' channels side by side (``PACK``),
the weights packed once on the host (`pack_stem_expand`, `pack_depthwise`,
`pack_pointwise`, gathered by `pack_stem_block1`).  Every conv's channel
width is then four times its own, which is the question for the card's
tensor cores (``make_fused_forward(..., s2d_stem="xla")``, timed by
`chip_smoke.py` phase 16 (a)).

BatchNorm is folded into conv weight + bias beforehand
(``ops/fused_mbconv.fold_conv_bn``); `stem_block1_args` turns the six folded
OIHW convs into the kernel's layouts once.

``fused_stem_block1`` calls the dispatcher op
``torch.ops.ssdseglib.fused_stem_block1``, whose CUDA implementation launches
the kernel and whose CPU implementation is the plain version
``fused_stem_block1_reference``; a CUDA call the kernel cannot take raises.
``fused_stem_block1.launches`` counts kernel launches, live or from inside
an exported program.  `kernel_config` reports the bf16 kernel's tile and chunk.
On a mesh that splits the rows the serving path runs the kernel unchanged on
this rank's window of image rows (`models/fused_inference._stem_block1`) and
counts those of its launches on ``fused_stem_block1.window_launches``.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
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


PACK = 4  # images whose channels `s2d_stem_block1_xla` packs side by side


# ---------------------------------------------------------------------------
# weight packing of the reformulation (host-side, NumPy; HWIO kernels, as the
# JAX package's packers take them)
# ---------------------------------------------------------------------------

def pack_stem_expand(kernel: np.ndarray, bias: np.ndarray):
    """(3,3,3,C) stride-2 SAME conv -> s2d 2x2 conv, batch-packed.

    SAME padding for stride 2 / kernel 3 on an even dimension is asymmetric
    (0 before, 1 after), so output pixel (i,j) reads input rows 2i+du, du in
    {0,1,2}.  In s2d space that is s2d pixel (i+a) parity py with du =
    2a+py; only (a,py) in {(0,0),(0,1),(1,0)} are inside the 3x3 window.
    Returns (W, b): W is (4*4*Cin_s2d, PACK*C) with rows ordered tap-major
    (a,b) then batch-group then s2d channel (py,px,cin); b is (PACK*C,).
    """
    kernel = np.asarray(kernel)
    kh, kw, cin, cout = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the stem kernel must be 3x3, got {kh}x{kw}")
    cs2d = 4 * cin
    w2 = np.zeros((2, 2, cs2d, cout), kernel.dtype)
    for a in range(2):
        for b in range(2):
            for py in range(2):
                for px in range(2):
                    du, dv = 2 * a + py, 2 * b + px
                    if du > 2 or dv > 2:
                        continue
                    sc = py * (2 * cin) + px * cin  # (2,2,cin) flat order
                    w2[a, b, sc : sc + cin, :] = kernel[du, dv]
    packed = np.zeros((4 * PACK * cs2d, PACK * cout), kernel.dtype)
    for t in range(4):  # tap index a*2+b
        a, b = divmod(t, 2)
        for g in range(PACK):
            r0 = t * PACK * cs2d + g * cs2d
            packed[r0 : r0 + cs2d, g * cout : (g + 1) * cout] = w2[a, b]
    return packed, np.tile(np.asarray(bias), PACK)


def pack_depthwise(kernel: np.ndarray, bias: np.ndarray):
    """(3,3,1,C) depthwise kernel -> (9, PACK*C) taps tiled across groups."""
    k = np.asarray(kernel).reshape(3, 3, -1).reshape(9, -1)
    return np.tile(k, (1, PACK)), np.tile(np.asarray(bias), PACK)


def pack_pointwise(kernel: np.ndarray, bias: np.ndarray):
    """(1,1,Cin,Cout) conv -> block-diagonal (PACK*Cin, PACK*Cout)."""
    k = np.asarray(kernel).reshape(np.asarray(kernel).shape[-2], -1)
    cin, cout = k.shape
    packed = np.zeros((PACK * cin, PACK * cout), k.dtype)
    for g in range(PACK):
        packed[g * cin : (g + 1) * cin, g * cout : (g + 1) * cout] = k
    return packed, np.tile(np.asarray(bias), PACK)


def pack_stem_block1(folded) -> Tuple[np.ndarray, ...]:
    """The twelve operands of `s2d_stem_block1_xla` (weight, bias of the six
    convs, in order) from the folded OIHW convs keyed
    ``backbone-block{0,1}-{expand,depthwise,project}`` (NumPy): each packed
    on its HWIO transpose by the packer of its kind, then laid out as a torch
    conv weight (OIHW): the stem's (PACK*32, PACK*12, 2, 2), the depthwise
    ones (PACK*C, 1, 3, 3), the 1x1s block-diagonal (PACK*O, PACK*I, 1, 1)."""
    packers = (pack_stem_expand, pack_depthwise, pack_pointwise,
               pack_pointwise, pack_depthwise, pack_pointwise)
    out = []
    for name, pack in zip(_NAMES, packers):
        kernel, bias = folded[name]
        w, b = pack(np.asarray(kernel, np.float32).transpose(2, 3, 1, 0),
                    np.asarray(bias, np.float32))
        if pack is pack_stem_expand:  # rows tap-major (a, b), then (group, s2d channel)
            w = w.reshape(2, 2, -1, w.shape[1]).transpose(3, 2, 0, 1)
        elif pack is pack_depthwise:  # taps row-major
            w = w.T.reshape(-1, 1, 3, 3)
        else:
            w = w.T[:, :, None, None]
        out += [np.ascontiguousarray(w), b]
    return tuple(out)


def s2d_stem_block1_xla(images: torch.Tensor, packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stem + block 1 as the reformulation of the JAX package's study, in
    library convs: space-to-depth (2x) of the image with PACK images'
    channels side by side, the stem as a 2x2 conv padded 0 before and 1
    after, the depthwise convs on PACK*32 and PACK*96 channels (the second
    at stride 2, SAME), the 1x1s block-diagonal, then the lanes unpacked to
    the batch.  Each conv rounds to the images' dtype and then adds its bias
    in that dtype, with ReLU6 where the network has it, as the JAX function
    does.  Plain PyTorch on any device: no kernel of its own.

    Args:
        images: (B, H, W, 3) NHWC, already rescaled to [-1, 1]; B a multiple
            of PACK, H and W of 4
        packed: the twelve tensors of `pack_stem_block1`, in the images'
            dtype and on their device
    Returns:
        the block-1 output (B, H/4, W/4, 24) in the images' dtype.
    """
    batch, h, w, c = images.shape
    if c != 3 or batch % PACK or h % 4 or w % 4:
        raise ValueError(f"images must be (B, H, W, 3) with B a multiple of {PACK} and H, W "
                         f"of 4, got {tuple(images.shape)}")
    h2, w2 = h // 2, w // 2
    groups = batch // PACK
    w1, b1, wd1, bd1, wp1, bp1, we2, be2, wd2, bd2, wp2, bp2 = packed

    def bias(y, b):
        return y + b.view(1, -1, 1, 1)

    def relu6(y):
        return y.clamp(0.0, 6.0)

    x = images.reshape(groups, PACK, h2, 2, w2, 2, 3).permute(0, 2, 4, 1, 3, 5, 6)
    x = x.reshape(groups, h2, w2, PACK * 12).permute(0, 3, 1, 2)  # channels-last NCHW
    e = relu6(bias(F.conv2d(F.pad(x, (0, 1, 0, 1)), w1), b1))
    d = relu6(bias(F.conv2d(e, wd1, padding=1, groups=e.shape[1]), bd1))
    p = bias(F.conv2d(d, wp1), bp1)
    e2 = relu6(bias(F.conv2d(p, we2), be2))
    d2 = relu6(bias(F.conv2d(F.pad(e2, (0, 1, 0, 1)), wd2, stride=2, groups=e2.shape[1]), bd2))
    o = bias(F.conv2d(d2, wp2), bp2)
    h4, w4 = o.shape[2], o.shape[3]
    o = o.permute(0, 2, 3, 1).reshape(groups, h4, w4, PACK, 24)
    return o.permute(0, 3, 1, 2, 4).reshape(batch, h4, w4, 24)


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
    if images.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_stem_block1 runs on cuda or cpu, not {images.device}")
    return torch.ops.ssdseglib.fused_stem_block1(images, list(folded))


fused_stem_block1.launches = 0
fused_stem_block1.window_launches = 0


def _cuda_op(images, folded):
    _check(images, folded)
    out = _launch(images, folded)
    fused_stem_block1.launches += 1
    return out


def _cpu_op(images, folded):
    _check(images, folded)
    return fused_stem_block1_reference(images, folded)


def _fake_op(images, folded):
    _check(images, folded)
    batch, h, w, _ = images.shape
    return images.new_empty((batch, h // 4, w // 4, 24))


_LIBRARY = torch.library.Library("ssdseglib", "FRAGMENT")
_LIBRARY.define("fused_stem_block1(Tensor images, Tensor[] folded) -> Tensor")
_LIBRARY.impl("fused_stem_block1", _cuda_op, "CUDA")
_LIBRARY.impl("fused_stem_block1", _cpu_op, "CPU")
torch.library.register_fake("ssdseglib::fused_stem_block1", _fake_op, lib=_LIBRARY)

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


# rows of a `tensor_core_step` at a time: its terms are (rows, k + 1, O) f64
_STEP_ROWS = 8192
# the exponent given to a zero term: below every other
_NO_EXPONENT = -1000


def tensor_core_step(x: torch.Tensor, w: torch.Tensor, acc=None, bits: int = 26
                     ) -> torch.Tensor:
    """x (N, k) @ w (k, O), k <= 16, as one step of the bf16 kernels' tensor
    cores (mma.sync m16n8k16) into the f32 accumulator ``acc`` (N, O), zero
    when None.  The H100's step, as the kernels' outputs show it
    (`chip_smoke.py` phases 3 and 3c and ``--step-models``: all 22.1 M
    outputs of the MBConv kernel's five widths and of the stem's): the k
    products are exact; a term's exponent is its leading bit's for the
    accumulator and the sum of its factors' for a product (whose significand
    lies in [1, 4)); every term is cut toward zero at 2^(E + 1 - ``bits``),
    E the largest exponent (26: two bits below an f32 ulp at E); the cut
    terms are summed exactly and the sum rounded toward zero to f32."""
    wd = w.double()
    w_exponent = torch.frexp(wd).exponent.masked_fill(wd == 0, _NO_EXPONENT)
    out = []
    for r0 in range(0, x.shape[0], _STEP_ROWS):
        xs = x[r0:r0 + _STEP_ROWS].double()
        terms = xs[:, :, None] * wd[None]
        x_exponent = torch.frexp(xs).exponent.masked_fill(xs == 0, _NO_EXPONENT)
        # frexp's exponent is E + 1; a product's is the sum of its factors' less 1
        top = (x_exponent[:, :, None] + w_exponent[None] - 1).amax(dim=1)
        if acc is not None:
            a = acc[r0:r0 + _STEP_ROWS].double()
            terms = torch.cat([terms, a[:, None]], dim=1)
            top = torch.maximum(top, torch.frexp(a).exponent.masked_fill(a == 0, _NO_EXPONENT))
        quantum = torch.ldexp(torch.ones_like(terms[:, 0]), top.clamp_min(-900) - bits)
        exact = (torch.trunc(terms / quantum[:, None]) * quantum[:, None]).sum(dim=1)
        rounded = exact.float()
        out.append(torch.where(rounded.double().abs() > exact.abs(),
                               torch.nextafter(rounded, torch.zeros_like(rounded)), rounded))
    if not out:
        return torch.zeros((0, w.shape[1]), dtype=torch.float32, device=x.device)
    return torch.cat(out)


def fused_stem_block1_reference(
    images: torch.Tensor, folded: Sequence[torch.Tensor], k_groups: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same six rounding
    points: f32 accumulation, rounding to the images' dtype after each conv
    + bias (before its ReLU6).  Same arguments as `fused_stem_block1`.

    With ``k_groups`` the four matrix products sum in the bf16 kernel's
    order: each 16-deep group of the K axis as one step into a zero
    accumulator (`tensor_core_step`), the partials added in k order to an
    f32 sum that starts at 0, then the bias."""
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
