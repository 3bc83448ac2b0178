"""Pointwise (1x1) convolution in int8, the quantize step and the epilogue
fused, for the serving path's ``quantize_pointwise`` option.

Counterpart of ``ssdseglib_tpu/models/fused_inference.py::_conv_int8``
(:72), which is XLA, not Pallas: there XLA fuses the activation quantize and
the dequantize, bias and cast into the fusions around an s8 x s8 -> s32
convolution.  Eager PyTorch fuses nothing, and the same steps as library
calls (a quantize pass, an s32 product written out and read back, then
dequantize, bias and clamp passes) move several times the bytes of the bf16
conv they replace.  So the function is one hand-written Hopper kernel
(``csrc/int8_pointwise.cu``).  On the NHWC view ``x (..., Ci)`` of a
channels-last activation:

    y = relu6(f32(q(x) @ wq.T) * dequant + bias)    in x's dtype
    q(v) = clamp(rint(f32(v) * inv_x_scale), -127, 127) as int8

It is bound by device memory on the H100 (at the serving path's shapes the
int8 products take a fifth to a third of the time it takes to read x and
write y once in bf16), so the kernel keeps device memory busy throughout:
persistent CTAs with the weights resident in shared memory, a TMA-fed ring
of x tiles for each of two consumer warpgroups, which quantize a tile to s8
and multiply it on the int8 tensor cores (``wgmma`` m64n128k32), and an
epilogue that a TMA store writes out while the next tile is loaded.
`_plan` is the kernel's launch plan (the source's ``make_plan``, the same
rules).  The activation is the heads' ReLU6, which follows both quantized
convs.

``int8_pointwise`` calls the dispatcher op ``torch.ops.ssdseglib.int8_pointwise``
(so ``torch.export`` records it as one node and a serving bundle captures
it), whose CUDA implementation launches the kernel and whose CPU
implementation is the plain version ``int8_pointwise_reference``; a CUDA
call the kernel cannot take raises.  ``int8_pointwise.launches`` counts
kernel launches, live or from inside an exported program.  The kernel and
its plain version give the same bits (see the source).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# 127^2 * Ci < 2^24: the int32 sum is exact as an f32 sum in any order, which
# makes the plain version's f32 product exact and the two equal
MAX_CI = 1024

# the kernel's geometry (csrc/int8_pointwise.cu: kTileRows, kChunk, kBlock,
# kBox, kMaxStages, kAlign)
TILE_ROWS = 64      # rows of x a consumer warpgroup takes at a time
CHUNK = 128         # channels of x a ring stage holds
BLOCK = 128         # output channels of one wgmma and of a weight block
BOX = 8192          # bytes of a TMA box and of an s8 tile
MAX_STAGES = 8
ALIGN = 1024
SMEM_LIMIT = 232448  # the H100's shared memory a block may opt into


class Plan(NamedTuple):
    """The kernel's launch plan for one shape (see the source's `Plan`)."""
    nc: int       # 128-channel blocks of Co a CTA holds resident: 1 or 2
    n_k: int      # ring stages a tile takes: ceil(Ci / 128)
    kp32: int     # the depth of x and the weights read: Ci rounded up to 32
    stages: int   # ring stages in all, (stages + 1) // 2 for warpgroup 0
    n_co: int     # chunks of Co: ceil(Co / (128 nc)); 1 = all weights resident
    n_tiles: int  # tiles of 64 rows
    grid: int     # CTAs
    smem: int     # dynamic shared memory, bytes


def _fixed_bytes(nc: int, n_k: int) -> int:
    """Shared memory besides the ring: alignment slack, the weights, two s8
    tiles and two staging boxes a consumer warpgroup, dequant and bias, the
    mbarriers."""
    return ALIGN + n_k * nc * BLOCK * CHUNK + 8 * BOX + 2 * nc * BLOCK * 4 + 16 * MAX_STAGES


def _plan(rows: int, ci: int, co: int, dtype: torch.dtype, sm_count: int,
          smem_limit: int = SMEM_LIMIT, ctas_per_sm: int = 1) -> Plan:
    """The launch plan of the kernel for x (rows, ci) -> y (rows, co) in
    ``dtype`` on a card of ``sm_count`` SMs, ``ctas_per_sm`` being what the
    occupancy calculator admits: all of Co resident when it fits beside a
    ring of two stages, else chunks of 128 output channels, each CTA holding
    one (or, with more chunks than CTAs, looping over them); the rest of the
    shared memory goes to the ring, at most MAX_STAGES stages."""
    elem = 2 if dtype == torch.bfloat16 else 4
    n_k = -(-ci // CHUNK)
    stage = TILE_ROWS * CHUNK * elem
    nc = 2 if co > BLOCK and _fixed_bytes(2, n_k) + 2 * stage <= smem_limit else 1
    stages = min(MAX_STAGES, (smem_limit - _fixed_bytes(nc, n_k)) // stage)
    n_co = -(-co // (nc * BLOCK))
    n_tiles = -(-rows // TILE_ROWS)
    ctas = sm_count * ctas_per_sm
    if n_co <= ctas:  # each CTA keeps one chunk; at least two tiles a CTA
        grid = min(ctas // n_co, (n_tiles + 1) // 2) * n_co
    else:
        grid = ctas
    return Plan(nc, n_k, -(-ci // 32) * 32, stages, n_co, n_tiles, grid,
                _fixed_bytes(nc, n_k) + stages * stage)


def _check(x, wq, inv_x_scale, dequant, bias) -> None:
    if x.dim() < 2:
        raise ValueError(f"x must be (..., Ci), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} is not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (the NHWC view of a channels-last tensor)")
    ci = x.shape[-1]
    if wq.dim() != 2 or wq.shape[1] != ci or wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8 (Co, {ci}), got {wq.dtype} {tuple(wq.shape)}")
    co = wq.shape[0]
    if ci % 8 != 0 or ci > MAX_CI:
        raise ValueError(f"Ci must be a multiple of 8 and at most {MAX_CI}, got {ci}")
    if co % 8 != 0 or co < 8:
        raise ValueError(f"Co must be a positive multiple of 8, got {co}")
    if inv_x_scale.numel() != 1 or inv_x_scale.dtype != torch.float32:
        raise ValueError("inv_x_scale must be one float32")
    for name, t in (("dequant", dequant), ("bias", bias)):
        if tuple(t.shape) != (co,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({co},), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("wq", wq), ("inv_x_scale", inv_x_scale), ("dequant", dequant),
                    ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def int8_pointwise(x: torch.Tensor, wq: torch.Tensor, inv_x_scale: torch.Tensor,
                   dequant: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Quantized 1x1 conv + bias + ReLU6.

    Args:
        x: (..., Ci) float32 or bfloat16, contiguous (the NHWC view of a
            channels-last activation); Ci a multiple of 8, at most MAX_CI
        wq: (Co, Ci) int8 weights; Co a multiple of 8
        inv_x_scale: one float32, 1 / the activation scale
        dequant: (Co,) float32, weight scale times activation scale
        bias: (Co,) float32
    All on x's device (16-byte aligned on the card).
    Returns:
        (..., Co) in x's dtype.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_pointwise runs on cuda or cpu, not {x.device}")
    return torch.ops.ssdseglib.int8_pointwise(x, wq, inv_x_scale, dequant, bias)


int8_pointwise.launches = 0


def _cuda_op(x, wq, inv_x_scale, dequant, bias):
    _check(x, wq, inv_x_scale, dequant, bias)
    out = _launch(x, wq, inv_x_scale, dequant, bias)
    int8_pointwise.launches += 1
    return out


def _cpu_op(x, wq, inv_x_scale, dequant, bias):
    _check(x, wq, inv_x_scale, dequant, bias)
    return int8_pointwise_reference(x, wq, inv_x_scale, dequant, bias)


def _fake_op(x, wq, inv_x_scale, dequant, bias):
    _check(x, wq, inv_x_scale, dequant, bias)
    return x.new_empty((*x.shape[:-1], wq.shape[0]))


_LIBRARY = torch.library.Library("ssdseglib", "FRAGMENT")
_LIBRARY.define("int8_pointwise(Tensor x, Tensor wq, Tensor inv_x_scale, Tensor dequant, "
                "Tensor bias) -> Tensor")
_LIBRARY.impl("int8_pointwise", _cuda_op, "CUDA")
_LIBRARY.impl("int8_pointwise", _cpu_op, "CPU")
torch.library.register_fake("ssdseglib::int8_pointwise", _fake_op, lib=_LIBRARY)


_kernel = None  # the library's int8_pointwise_launch, once loaded


def _launch(x, wq, inv_x_scale, dequant, bias,
            xq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch on CUDA tensors that passed `_check`; counts nothing.
    ``xq``, an int8 tensor of x's shape, receives the kernel's quantized
    activations."""
    global _kernel
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"int8_pointwise runs on cuda or cpu, not {device}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_pointwise: x and wq must be 16-byte aligned")
    if _kernel is None:
        from ssdseglib_torch.ops._cuda_build import load_library

        _kernel = load_library().int8_pointwise_launch
    ci, co = x.shape[-1], wq.shape[0]
    rows = x.numel() // ci
    out = torch.empty((*x.shape[:-1], co), dtype=x.dtype, device=device)
    if rows == 0:
        return out
    args = (_DTYPE_CODES[x.dtype], x.data_ptr(), wq.data_ptr(), inv_x_scale.data_ptr(),
            dequant.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if xq is None else xq.data_ptr(), rows, ci, co,
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = _kernel(*args)
    else:  # the launcher plans for, and launches on, the current device
        with torch.cuda.device(device):
            err = _kernel(*args)
    if err != 0:
        raise RuntimeError(
            f"int8_pointwise kernel launch failed with cudaError {err} "
            f"(rows={rows}, Ci={ci}, Co={co}, {x.dtype})"
        )
    return out


def quantize_activations(x: torch.Tensor, inv_x_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's q(x): round half to even of the f32 product, clamped to
    [-127, 127], as int8."""
    return torch.round(x.float() * inv_x_scale.float()).clamp(-127.0, 127.0).to(torch.int8)


def int8_pointwise_reference(x, wq, inv_x_scale, dequant, bias) -> torch.Tensor:
    """Plain PyTorch version of the kernel, bit for bit: the int8 values
    multiplied as f32 (exact: |q| <= 127 fits TF32's mantissa too, and every
    partial sum is an integer below 2^24), then the product times ``dequant``
    and plus ``bias`` as two roundings, clamped to [0, 6] in f32 and rounded
    once to x's dtype.  Same arguments as `int8_pointwise`."""
    ci, co = x.shape[-1], wq.shape[0]
    q = quantize_activations(x, inv_x_scale.reshape(())).reshape(-1, ci)
    acc = torch.matmul(q.float(), wq.float().t())
    y = (acc * dequant) + bias
    return y.clamp(0.0, 6.0).to(x.dtype).reshape(*x.shape[:-1], co)
