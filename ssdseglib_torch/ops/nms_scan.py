"""Greedy NMS selection scan over score-sorted candidates.

Counterpart of ``ssdseglib_tpu/ops/nms_pallas.py``.  The top-K formulation
of the combined NMS (``ops/nms.py``, ``method="topk"``) is plain tensor code
except for one sequential piece: the greedy scan in which a kept candidate
suppresses every later one that overlaps it too much, and selection stops
at ``max_keep``.  That scan runs as one hand-written Hopper kernel
(``csrc/nms_scan.cu``): one CTA per (batch, class) row, the row's IoU
matrix turned into a bit matrix in shared memory, and one warp that walks
the taken candidates with the suppressed set in registers.

``greedy_select`` calls the dispatcher op ``torch.ops.ssdseglib.greedy_select``
(the threshold as a 0-d f32 tensor on the IoU's device), whose CUDA
implementation launches the kernel and whose CPU implementation is the plain
version ``greedy_select_reference``; a CUDA call the kernel cannot take
raises.  ``greedy_select.launches`` counts kernel launches, live or from
inside an exported program.
"""

from __future__ import annotations

import torch

# The bit matrix of one row, K * ceil(K / 32) * 4 bytes, has to fit the
# 227 KB of shared memory a block may use.
MAX_K = 1344


def _check(iou: torch.Tensor, candidate_valid: torch.Tensor) -> None:
    if candidate_valid.dim() < 1:
        raise ValueError("candidate_valid must be (..., K)")
    k = candidate_valid.shape[-1]
    if tuple(iou.shape) != tuple(candidate_valid.shape) + (k,):
        raise ValueError(
            f"iou has shape {tuple(iou.shape)}, expected "
            f"{tuple(candidate_valid.shape) + (k,)} for candidate_valid "
            f"{tuple(candidate_valid.shape)}"
        )
    if k < 1:
        raise ValueError("K must be at least 1")
    if iou.dtype != torch.float32:
        raise ValueError(f"iou must be float32, got {iou.dtype}")
    if candidate_valid.dtype != torch.bool:
        raise ValueError(f"candidate_valid must be bool, got {candidate_valid.dtype}")
    if candidate_valid.device != iou.device:
        raise ValueError(
            f"candidate_valid is on {candidate_valid.device}; iou is on {iou.device}"
        )
    if not (iou.is_contiguous() and candidate_valid.is_contiguous()):
        raise ValueError("iou and candidate_valid must be contiguous")


def _device_threshold(iou_threshold, device: torch.device) -> torch.Tensor:
    """The threshold as one f32 on ``device``, without reading a device
    tensor back: a Python number fills a new tensor."""
    if isinstance(iou_threshold, torch.Tensor):
        if iou_threshold.numel() != 1:
            raise ValueError("iou_threshold must be a scalar")
        return iou_threshold.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(iou_threshold), dtype=torch.float32, device=device)


def greedy_select(
    iou: torch.Tensor,
    candidate_valid: torch.Tensor,
    iou_threshold,
    max_keep: int,
) -> torch.Tensor:
    """Greedy NMS over score-sorted candidates.

    Args:
        iou: (..., K, K) float32 pairwise IoU of candidates sorted by
            descending score, contiguous
        candidate_valid: (..., K) bool, above the score threshold
        iou_threshold: Python number or 0-d tensor; a kept candidate
            suppresses later ones with IoU strictly above it
        max_keep: cap on selections per leading index
    Returns:
        (..., K) bool keep mask.
    """
    if iou.device.type not in ("cuda", "cpu"):
        raise ValueError(f"greedy_select runs on cuda or cpu, not {iou.device}")
    return torch.ops.ssdseglib.greedy_select(
        iou, candidate_valid, _device_threshold(iou_threshold, iou.device), int(max_keep))


greedy_select.launches = 0


def _cuda_op(iou, candidate_valid, iou_threshold, max_keep):
    _check(iou, candidate_valid)
    k = candidate_valid.shape[-1]
    if k > MAX_K:
        raise ValueError(
            f"K = {k} exceeds the kernel's limit of {MAX_K} candidates per row "
            "(the row's bit matrix has to fit a block's shared memory)"
        )

    from ssdseglib_torch.ops._cuda_build import load_library

    lib = load_library()
    rows = candidate_valid.numel() // k
    keep = torch.empty_like(candidate_valid)
    if rows == 0:
        return keep
    with torch.cuda.device(iou.device):
        err = lib.nms_scan_launch(
            iou.data_ptr(), candidate_valid.data_ptr(), iou_threshold.data_ptr(),
            keep.data_ptr(), rows, k, max_keep,
            torch.cuda.current_stream(iou.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"NMS scan kernel launch failed with cudaError {err} "
            f"(rows={rows}, K={k}, max_keep={max_keep})"
        )
    greedy_select.launches += 1
    return keep


def _cpu_op(iou, candidate_valid, iou_threshold, max_keep):
    _check(iou, candidate_valid)
    return greedy_select_reference(iou, candidate_valid, iou_threshold, max_keep)


def _fake_op(iou, candidate_valid, iou_threshold, max_keep):
    _check(iou, candidate_valid)
    return torch.empty_like(candidate_valid)


_LIBRARY = torch.library.Library("ssdseglib", "FRAGMENT")
_LIBRARY.define("greedy_select(Tensor iou, Tensor candidate_valid, Tensor iou_threshold, "
                "int max_keep) -> Tensor")
_LIBRARY.impl("greedy_select", _cuda_op, "CUDA")
_LIBRARY.impl("greedy_select", _cpu_op, "CPU")
torch.library.register_fake("ssdseglib::greedy_select", _fake_op, lib=_LIBRARY)


def greedy_select_reference(
    iou: torch.Tensor,
    candidate_valid: torch.Tensor,
    iou_threshold,
    max_keep: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the sequential scan written out,
    one step per candidate, vectorised over the leading dimensions.  Same
    arguments and result as `greedy_select`."""
    k = candidate_valid.shape[-1]
    if isinstance(iou_threshold, torch.Tensor):
        iou_threshold = iou_threshold.to(device=iou.device, dtype=torch.float32)
    positions = torch.arange(k, device=iou.device)
    keep = torch.zeros_like(candidate_valid)
    suppressed = torch.zeros_like(candidate_valid)
    count = torch.zeros(candidate_valid.shape[:-1], dtype=torch.int32, device=iou.device)
    for i in range(k):
        take = candidate_valid[..., i] & ~suppressed[..., i] & (count < max_keep)
        keep[..., i] = take
        count = count + take.to(torch.int32)
        # a selected box suppresses all later candidates overlapping too much
        overlap = iou[..., i, :] > iou_threshold
        suppressed = suppressed | (take[..., None] & overlap & (positions > i))
    return keep
