"""Combined non-maximum suppression (PyTorch), counterpart of
ssdseglib_tpu/ops/nms.py (``tf.image.combined_non_max_suppression`` as the
reference calls it at ssdseglib/layers.py:141-149).

``method="exact"`` (the default): iterative argmax, exact over all N anchors:

1. per class: `max_boxes_per_class` rounds of [argmax score over every
   not-yet-suppressed candidate above the score threshold (strict >), then
   suppress all candidates with IoU > iou_threshold against the selection]
   -- greedy NMS restated, with no top-K prefilter.
2. across classes: class-major concatenation, stable top-`max_total` by
   score (TF's concat-then-top_k combine step, including tie order).

``method="topk"``: a top-K prefilter and one suppression scan, for
workloads where `max_boxes_per_class` is large enough that M sequential
argmax rounds lose to one scan:

1. per class: the `max_candidates_per_class` highest scores, sorted
   descending with ties to the lower index (a stable sort), their (K, K)
   pairwise IoU, and the greedy scan over them (`ops/nms_scan.py`: a
   hand-written kernel on a CUDA tensor, its plain version on a CPU tensor).
2. across classes: the same class-major stable top-`max_total`.

It equals the exact method only while at most K candidates of a class clear
the score threshold; beyond that it truncates to the K best.

Static shapes and no host synchronisation: the thresholds may be 0-d
device tensors, so one serving path covers every operating point.  Argmax
ties go to the first index, as in JAX.  IoU uses the plain (no +1)
convention with corner canonicalization, matching TF NMS.
"""

from __future__ import annotations

from typing import Dict

import torch

from ssdseglib_torch.config import NmsConfig
from ssdseglib_torch.ops.nms_scan import greedy_select


def _pairwise_iou_yx(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) boxes in (ymin, xmin, ymax, xmax) layout.

    Corners are canonicalized (min/max swap) and areas use the plain
    continuous-coordinate convention, matching the TF NMS kernel; a pair
    whose union is not positive has IoU 0.
    """
    ymin = torch.minimum(boxes[..., 0], boxes[..., 2])
    xmin = torch.minimum(boxes[..., 1], boxes[..., 3])
    ymax = torch.maximum(boxes[..., 0], boxes[..., 2])
    xmax = torch.maximum(boxes[..., 1], boxes[..., 3])

    inter_h = (
        torch.minimum(ymax[..., :, None], ymax[..., None, :])
        - torch.maximum(ymin[..., :, None], ymin[..., None, :])
    ).clamp(min=0.0)
    inter_w = (
        torch.minimum(xmax[..., :, None], xmax[..., None, :])
        - torch.maximum(xmin[..., :, None], xmin[..., None, :])
    ).clamp(min=0.0)
    inter = inter_h * inter_w
    area = (ymax - ymin) * (xmax - xmin)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0.0, inter / union, 0.0)


def _exact_greedy_nms(boxes_yx, scores_cn, iou_threshold, score_threshold,
                      max_keep: int):
    """Iterative-argmax greedy NMS, exact over all N candidates.

    Args:
        boxes_yx: (B, N, 4) corners shared across classes
        scores_cn: (B, C, N) per-class scores
    Returns:
        sel_idx: (B, C, M) selected candidate indices (class-local rounds)
        sel_scores: (B, C, M) selected scores, -inf where no selection
    """
    n = scores_cn.shape[-1]
    ymin = torch.minimum(boxes_yx[..., 0], boxes_yx[..., 2])  # (B, N)
    xmin = torch.minimum(boxes_yx[..., 1], boxes_yx[..., 3])
    ymax = torch.maximum(boxes_yx[..., 0], boxes_yx[..., 2])
    xmax = torch.maximum(boxes_yx[..., 1], boxes_yx[..., 3])
    area = (ymax - ymin) * (xmax - xmin)
    positions = torch.arange(n, device=scores_cn.device)

    avail = scores_cn > score_threshold  # (B, C, N)
    sel_idx, sel_scores = [], []
    for _ in range(max_keep):
        masked = torch.where(avail, scores_cn, float("-inf"))
        idx = masked.argmax(dim=-1)  # (B, C), first index on ties
        sel = masked.gather(-1, idx[..., None])[..., 0]
        found = torch.isfinite(sel)  # any candidate left this round?

        sy0, sx0, sy1, sx1, sarea = (
            v.gather(1, idx) for v in (ymin, xmin, ymax, xmax, area)
        )
        inter_h = (
            torch.minimum(sy1[..., None], ymax[:, None, :])
            - torch.maximum(sy0[..., None], ymin[:, None, :])
        ).clamp(min=0.0)
        inter_w = (
            torch.minimum(sx1[..., None], xmax[:, None, :])
            - torch.maximum(sx0[..., None], xmin[:, None, :])
        ).clamp(min=0.0)
        inter = inter_h * inter_w  # (B, C, N)
        union = sarea[..., None] + area[:, None, :] - inter
        iou = torch.where(union > 0.0, inter / union, 0.0)

        removed = (iou > iou_threshold) | (positions == idx[..., None])
        avail = avail & ~(found[..., None] & removed)
        sel_idx.append(idx)
        sel_scores.append(sel)
    return torch.stack(sel_idx, dim=-1), torch.stack(sel_scores, dim=-1)


def _top_candidates(boxes_yx: torch.Tensor, scores_cn: torch.Tensor, k: int):
    """The K best candidates of each class: (scores (B, C, K) sorted
    descending with ties to the lower index, their boxes (B, C, K, 4)).  A
    stable sort, because `torch.topk` promises no order among ties."""
    b, c, n = scores_cn.shape
    order = torch.sort(scores_cn, dim=-1, descending=True, stable=True)
    index = order.indices[..., :k, None].expand(b, c, k, 4)
    boxes = boxes_yx[:, None].expand(b, c, n, 4).gather(2, index)
    return order.values[..., :k].contiguous(), boxes


def combined_nms(
    boxes_yx: torch.Tensor,
    scores: torch.Tensor,
    cfg: NmsConfig,
    method: str = "exact",
    iou_threshold=None,
    score_threshold=None,
) -> Dict[str, torch.Tensor]:
    """Combined per-class NMS with shared boxes.

    Args:
        boxes_yx: (B, N, 4) decoded corners in (ymin, xmin, ymax, xmax) order
            (shared across classes)
        scores: (B, N, C) per-class probabilities (class 0 = background is
            NOT special-cased, like the reference)
        method: "exact" (default, iterative argmax over all N candidates) or
            "topk" (top-K prefilter + suppression scan, see the module
            docstring)
        iou_threshold / score_threshold: optional overrides of the config
            values; Python floats or 0-d tensors on the scores' device.
    Returns:
        dict with
            boxes: (B, T, 4) kept boxes, (ymin, xmin, ymax, xmax), zero padded
            scores: (B, T) kept scores, zero padded
            classes: (B, T) float class ids, zero padded
            valid: (B,) number of valid rows per sample
        where T = min(cfg.max_boxes_per_sample, number of per-class slots):
        C * cfg.max_boxes_per_class slots under "exact", C * K under "topk".
    """
    b, n, c = scores.shape
    if iou_threshold is None:
        iou_threshold = cfg.iou_threshold
    if score_threshold is None:
        score_threshold = cfg.score_threshold
    scores_cn = scores.transpose(1, 2)  # (B, C, N)

    if method == "exact":
        m = cfg.max_boxes_per_class
        sel_idx, sel_scores = _exact_greedy_nms(
            boxes_yx, scores_cn, iou_threshold, score_threshold, m
        )
        flat_scores = sel_scores.reshape(b, c * m)
        flat_boxes = boxes_yx[:, None].expand(b, c, n, 4).gather(
            2, sel_idx[..., None].expand(b, c, m, 4)
        )
    elif method == "topk":
        m = min(cfg.max_candidates_per_class, n)
        cand_scores, cand_boxes = _top_candidates(boxes_yx, scores_cn, m)
        keep = greedy_select(
            _pairwise_iou_yx(cand_boxes), cand_scores > score_threshold,
            iou_threshold, cfg.max_boxes_per_class,
        )
        flat_scores = torch.where(keep, cand_scores, float("-inf")).reshape(b, c * m)
        flat_boxes = cand_boxes
    else:
        raise ValueError(f"unknown NMS method {method!r}")
    # combine across classes: class-major flatten, stable top-T by score
    flat_boxes = flat_boxes.reshape(b, c * m, 4)
    flat_classes = torch.arange(c, dtype=torch.float32, device=scores.device)
    flat_classes = flat_classes[None, :, None].expand(b, c, m).reshape(b, c * m)

    order = torch.argsort(-flat_scores, dim=-1, stable=True)
    order = order[:, : cfg.max_boxes_per_sample]
    top_scores = flat_scores.gather(-1, order)
    top_boxes = flat_boxes.gather(1, order[..., None].expand(-1, -1, 4))
    top_classes = flat_classes.gather(-1, order)

    valid_row = torch.isfinite(top_scores)
    return {
        "boxes": torch.where(valid_row[..., None], top_boxes, 0.0),
        "scores": torch.where(valid_row, top_scores, 0.0),
        "classes": torch.where(valid_row, top_classes, 0.0),
        "valid": valid_row.sum(dim=-1, dtype=torch.int32),
    }
