"""Weight gradient of a 1x1 stride-1 dense convolution, three ways.

Counterpart of the three Pallas kernels of
``tests/tpu_scripts/mosaic_reshape_probe.py``, as hand-written Hopper kernels
(``csrc/pointwise_wgrad.cu``).  With x (..., Ci) and dy (..., Co), K the
product of the leading axes:

    wgrad_mma   dW[o,i] = sum_k dy[k,o] * x[k,i], bf16 operands, the product
                on the tensor cores inside the kernel, f32 sums  (`kernel`)
    wgrad_fma   the same dW by FMAs on the CUDA cores, bf16 or f32 operands
                cast to f32 in registers                        (`vpu_kernel`)
    wgrad_copy  out[o,i] = sum_k x[k,i] + sum_k dy[k,o]: the same loads and no
                product, the memory floor of the other two     (`copy_kernel`)

All three return (Co, Ci) -- the layout of a (Co, Ci, 1, 1) conv weight -- in
f32 or bf16 (``out_dtype``), from ONE launch: a split-K reduction whose
partial sums are added inside the same launch, in an order fixed by the grid
(no atomics in the sums): the same bits on every run.  The partials' scratch
is allocated once per (device, stream, Ci, Co, CTAs) and kept.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
(``*_reference``) on CPU tensors; a CUDA call the kernel cannot take raises.
``<wrapper>.launches`` counts the calls that reached the kernel.
`wgrad_applicable` is the envelope the model's gate asks
(``models/blocks.set_wgrad_impl('cuda')``); `pointwise_wgrad` picks the
kernel by dtype; `wgrad_study` times the routes against each other.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import Callable, Dict, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MMA, _FMA, _COPY = 0, 1, 2
TILE = 16  # channel counts come in multiples of the tensor-core tile edge


def channels_applicable(ci: int, co: int) -> bool:
    """The kernels' channel envelope: multiples of 16, Ci <= 64, Co <= 96 and
    at most 8 accumulator tiles of 16 x 16 (``channels_ok`` in the source)."""
    return (
        ci >= TILE and co >= TILE and ci % TILE == 0 and co % TILE == 0
        and ci <= 64 and co <= 96 and (ci // TILE) * (co // TILE) <= 8
    )


def wgrad_applicable(ci: int, co: int, dtype: torch.dtype) -> bool:
    """Where ``set_wgrad_impl('cuda')`` routes a 1x1 stride-1 dense conv's
    weight gradient through the kernels: bfloat16 (tensor-core kernel) or
    float32 (CUDA-core kernel) inside `channels_applicable`.  In the flagship
    model that is backbone-block0-project (32 -> 16) and
    backbone-block1-expand (16 -> 96)."""
    return dtype in _DTYPE_CODES and channels_applicable(ci, co)


def _check(name: str, x: torch.Tensor, dy: torch.Tensor) -> int:
    """The kernels' input contract; returns K."""
    if x.dim() < 2 or x.shape[:-1] != dy.shape[:-1]:
        raise ValueError(
            f"{name}: x (..., Ci) and dy (..., Co) must share their leading axes, got "
            f"{tuple(x.shape)} and {tuple(dy.shape)}"
        )
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"{name}: operands must be float32 or bfloat16, alike and on one device, got "
            f"{x.dtype} on {x.device} and {dy.dtype} on {dy.device}"
        )
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor {tuple(x.shape)}")
    if not channels_applicable(x.shape[-1], dy.shape[-1]):
        raise ValueError(
            f"{name}: channels ({x.shape[-1]}, {dy.shape[-1]}) are outside the kernels' "
            "envelope (see channels_applicable)"
        )
    return x.numel() // x.shape[-1]


# Scratch of the in-launch reduction, allocated once per (device, stream, Ci,
# Co, CTAs) and kept: (partials (CTAs, Co, Ci) f32, counters int32).  Sharing
# it between launches is safe because a buffer is only ever used on its own
# stream, and launches on one stream run in order: a launch starts after the
# previous one has read its partials and reset its counters to 0.
_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _grid(lib, kernel: int, k: int, ci: int, co: int, ctas: int = 0,
          rows: int = 0) -> Tuple[int, int]:
    """(CTAs, counters) of a launch as the library splits K; ``ctas`` 0 for
    its built-in grid, ``rows`` the CUDA-core kernel's rows a chunk (0 for
    its built-in choice; the other kernels' split ignores it)."""
    n_ctas, n_counters = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.pointwise_wgrad_grid(kernel, k, ci, co, rows, ctas, ctypes.byref(n_ctas),
                                   ctypes.byref(n_counters))
    if err != 0:
        raise RuntimeError(f"no grid for K={k}, Ci={ci}, Co={co}: cudaError {err}")
    return n_ctas.value, n_counters.value


def _scratch(device: torch.device, stream: int, ci: int, co: int, ctas: int,
             counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream, ci, co, ctas)
    if key not in _SCRATCH:
        # counters start at 0, and every launch leaves them at 0
        _SCRATCH[key] = (torch.empty((ctas, co, ci), dtype=torch.float32, device=device),
                         torch.zeros(ctas + 1, dtype=torch.int32, device=device))
    partials, counter = _SCRATCH[key]
    assert counters <= counter.numel()
    return partials, counter


# (device, stream, kernel, K, Ci, Co) -> the cached scratch's (partials,
# counters) addresses: one dictionary lookup per call after the first
_PLANS: Dict[tuple, Tuple[int, int]] = {}


def _launch(kernel: int, name: str, x: torch.Tensor, dy: torch.Tensor, k: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    from ssdseglib_torch.ops._cuda_build import load_library

    device = x.device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    x_ptr, dy_ptr = x.data_ptr(), dy.data_ptr()
    if x_ptr % 16 or dy_ptr % 16:
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    lib = load_library()
    ci, co = x.shape[-1], dy.shape[-1]
    # the current stream's raw handle, without building a torch.cuda.Stream
    # object on every call's host path
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream, kernel, k, ci, co)
    plan = _PLANS.get(key)
    if plan is None:
        partials, counters = _scratch(device, stream, ci, co, *_grid(lib, kernel, k, ci, co))
        plan = _PLANS[key] = (partials.data_ptr(), counters.data_ptr())
    out = torch.empty((co, ci), dtype=out_dtype, device=device)
    args = (kernel, _DTYPE_CODES[x.dtype], x_ptr, dy_ptr, *plan, out.data_ptr(),
            _DTYPE_CODES[out_dtype], k, ci, co, 0, 0, stream)
    if device.index == torch.cuda.current_device():
        err = lib.pointwise_wgrad_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.pointwise_wgrad_launch(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with cudaError {err} (K={k}, Ci={ci}, Co={co}, "
            f"{x.dtype})"
        )
    return out


def _out_dtype(out_dtype) -> torch.dtype:
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    return out_dtype


def wgrad_mma(x: torch.Tensor, dy: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dW = dy^T x on the tensor cores: bfloat16 x (..., Ci), dy (..., Co)
    -> (Co, Ci), the layout of a (Co, Ci, 1, 1) conv weight, summed in f32
    (exact bf16 products) and written in ``out_dtype``."""
    k = _check("wgrad_mma", x, dy)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"wgrad_mma takes bfloat16 operands, got {x.dtype}")
    out_dtype = _out_dtype(out_dtype)
    if x.device.type == "cpu":
        return wgrad_mma_reference(x, dy).to(out_dtype)
    dw = _launch(_MMA, "wgrad_mma", x, dy, k, out_dtype)
    wgrad_mma.launches += 1
    return dw


wgrad_mma.launches = 0


def wgrad_fma(x: torch.Tensor, dy: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dW = dy^T x by f32 FMAs on the CUDA cores: float32 or bfloat16
    x (..., Ci), dy (..., Co) -> (Co, Ci) in ``out_dtype``."""
    k = _check("wgrad_fma", x, dy)
    out_dtype = _out_dtype(out_dtype)
    if x.device.type == "cpu":
        return wgrad_fma_reference(x, dy).to(out_dtype)
    dw = _launch(_FMA, "wgrad_fma", x, dy, k, out_dtype)
    wgrad_fma.launches += 1
    return dw


wgrad_fma.launches = 0


def wgrad_copy(x: torch.Tensor, dy: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[o, i] = sum_k x[k, i] + sum_k dy[k, o]: the loads of the weight
    gradient without its product.  float32 or bfloat16 -> (Co, Ci) in
    ``out_dtype``."""
    k = _check("wgrad_copy", x, dy)
    out_dtype = _out_dtype(out_dtype)
    if x.device.type == "cpu":
        return wgrad_copy_reference(x, dy).to(out_dtype)
    out = _launch(_COPY, "wgrad_copy", x, dy, k, out_dtype)
    wgrad_copy.launches += 1
    return out


wgrad_copy.launches = 0


def wgrad_mma_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `wgrad_mma`: one f32 matrix product of the
    operands' f32 values, (Co, Ci)."""
    return dy.reshape(-1, dy.shape[-1]).float().t() @ x.reshape(-1, x.shape[-1]).float()


def wgrad_fma_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `wgrad_fma`, written as the kernel computes
    it: per output channel a multiply and a sum over K, in f32, (Co, Ci)."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    g2 = dy.reshape(-1, dy.shape[-1]).float()
    return torch.stack([(x2 * g2[:, o:o + 1]).sum(dim=0) for o in range(g2.shape[1])], dim=0)


def wgrad_copy_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `wgrad_copy`, (Co, Ci)."""
    sx = x.reshape(-1, x.shape[-1]).float().sum(dim=0)
    sy = dy.reshape(-1, dy.shape[-1]).float().sum(dim=0)
    return sy[:, None] + sx[None, :]


def pointwise_wgrad(x: torch.Tensor, dy: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weight gradient (Co, Ci) in ``out_dtype`` by the kernel of the
    operands' dtype: bfloat16 on the tensor cores, float32 on the CUDA
    cores."""
    kernel = wgrad_mma if x.dtype == torch.bfloat16 else wgrad_fma
    return kernel(x, dy, out_dtype)


def dot_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The giant-K library product x^T dy with f32 accumulation and an f32
    result, whatever the operands' dtype.  On the card a bfloat16 product
    asks the library for the f32 result directly
    (``torch.mm(..., out_dtype=torch.float32)``), so neither operand is
    copied; on the CPU, where that overload does not exist, the operands are
    widened first."""
    x2 = x.reshape(-1, x.shape[-1])
    g2 = dy.reshape(-1, dy.shape[-1])
    if x2.dtype == torch.float32:
        return x2.t() @ g2
    if x2.device.type == "cuda":
        return torch.mm(x2.t(), g2, out_dtype=torch.float32)
    return x2.float().t() @ g2.float()


def _cuda_median_ms(fn: Callable[[], object], runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wgrad_study(x: torch.Tensor, dy: torch.Tensor) -> Dict[str, float]:
    """Which route to the 1x1 weight gradient is fastest on this card, for
    NHWC bfloat16 x (B, H, W, Ci) and dy (B, H, W, Co) on it.

    Checks `wgrad_mma` against the f32 product of the same values (largest
    difference below 2e-2 of the largest magnitude) and times five routes by
    CUDA events, median of 20 after 3 warm-ups: the library's convolution
    backward (weight only), the giant-K library product (`dot_wgrad`), and
    the three kernels.  Returns {"rel_err", "aten_ms", "dot_ms", "mma_ms",
    "copy_ms", "fma_ms"}.
    """
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError("wgrad_study times NHWC tensors on a CUDA device")
    ci, co = x.shape[-1], dy.shape[-1]
    want = wgrad_mma_reference(x, dy)
    got = wgrad_mma(x, dy)
    rel_err = float((got - want).abs().max() / want.abs().max())
    if not rel_err < 2e-2:
        raise AssertionError(f"wgrad_mma is off its f32 reference by {rel_err}")
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels-last views
    weight = torch.zeros((co, ci, 1, 1), dtype=x.dtype, device=x.device)

    def aten():
        return torch.ops.aten.convolution_backward(
            dy_nchw, x_nchw, weight, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [False, True, False])

    arms = {"aten_ms": aten, "dot_ms": lambda: dot_wgrad(x, dy),
            "mma_ms": lambda: wgrad_mma(x, dy), "copy_ms": lambda: wgrad_copy(x, dy),
            "fma_ms": lambda: wgrad_fma(x, dy)}
    result = {"rel_err": rel_err}
    for name, fn in arms.items():
        result[name] = _cuda_median_ms(fn)
    return result
