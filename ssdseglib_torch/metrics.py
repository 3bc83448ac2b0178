"""Streaming train-time metrics (PyTorch), counterparts of
ssdseglib_tpu/metrics.py (reference ssdseglib/metrics.py).

Same per-sample contract as the losses: ``(batch,)`` values the train loop
averages.  Reference quirks preserved:

- the mask IoU is *soft* -- computed on probabilities, no argmax
- the box-IoU metric clamps decoded width/height at 0 because a training
  network can emit invalid boxes
- "categorical accuracy" counts elementwise one-hot agreement per class --
  zeros agreeing with zeros count too
- the box IoU divides by the positive count without a clamp: a sample
  without positives gives NaN, as in the JAX package
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.losses import _cached_weights
from ssdseglib_torch.parallel.spatial import sum_over_rows

_EPSILON = 1e-7


def jaccard_iou_segmentation_masks(classes_weights: Sequence[float]) -> Callable:
    """Weighted soft mask IoU factory (on split rows, the per-sample sums
    are the global map's: `parallel.spatial.sum_over_rows`)."""
    weights = _cached_weights(classes_weights)

    def metric(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        intersection, total = sum_over_rows(torch.stack([(y_true * y_pred).sum(dim=(1, 2)),
                                                         (y_true + y_pred).sum(dim=(1, 2))]))
        iou = intersection / (total - intersection + _EPSILON)
        return (iou * weights(y_pred)).sum(dim=-1)

    return metric


def jaccard_iou_bounding_boxes(
    anchors: Anchors,
    standard_deviations: Tuple[float, float, float, float],
) -> Callable:
    """Decoded-box IoU metric factory.

    Decodes both ground truth and predictions from standardized offsets with
    the ``max(0, size)`` clamp, zeroes background rows, and averages IoU over
    the positive anchors of each sample.
    """
    std_cx, std_cy, std_w, std_h = (float(s) for s in standard_deviations)
    centroids = torch.from_numpy(anchors.centroids.copy())
    cache = {}

    def _anchors(like: torch.Tensor):
        if like.device not in cache:
            cache[like.device] = centroids.to(like.device).unbind(-1)
        return cache[like.device]

    def _decode(offsets: torch.Tensor, not_background: torch.Tensor):
        acx, acy, aw, ah = _anchors(offsets)
        cx = (offsets[..., 0] * std_cx * aw + acx) * not_background
        cy = (offsets[..., 1] * std_cy * ah + acy) * not_background
        w = ((torch.exp(offsets[..., 2] * std_w) - 1.0) * aw).clamp_min(0.0)
        h = ((torch.exp(offsets[..., 3] * std_h) - 1.0) * ah).clamp_min(0.0)
        w = w * not_background
        h = h * not_background
        xmin = (cx - (w - 1.0) / 2.0) * not_background
        ymin = (cy - (h - 1.0) / 2.0) * not_background
        xmax = (cx + (w - 1.0) / 2.0) * not_background
        ymax = (cy + (h - 1.0) / 2.0) * not_background
        return xmin, ymin, xmax, ymax, w, h

    def metric(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        not_background = (y_true.abs().sum(dim=-1) > 0.0).to(y_pred.dtype)
        px0, py0, px1, py1, pw, ph = _decode(y_pred, not_background)
        tx0, ty0, tx1, ty1, tw, th = _decode(y_true, not_background)

        iw = (torch.minimum(px1, tx1) - torch.maximum(px0, tx0) + 1.0).clamp_min(
            0.0) * not_background
        ih = (torch.minimum(py1, ty1) - torch.maximum(py0, ty0) + 1.0).clamp_min(
            0.0) * not_background

        area_t = tw * th
        area_p = pw * ph
        inter = iw * ih
        iou = inter / (area_p + area_t - inter + _EPSILON)
        return iou.sum(dim=-1) / not_background.sum(dim=-1)

    return metric


def categorical_accuracy(classes_weights: Sequence[float]) -> Callable:
    """Weighted elementwise one-hot agreement factory."""
    weights = _cached_weights(classes_weights)

    def metric(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        # exactly one hot per row; torch.argmax returns the first maximum
        num_classes = y_pred.shape[-1]
        idx = y_pred.argmax(dim=-1)
        pred_one_hot = (
            torch.arange(num_classes, device=y_pred.device) == idx[..., None]
        ).to(y_pred.dtype)
        agree = (pred_one_hot == y_true).to(y_pred.dtype)
        agree = agree.sum(dim=1)  # (B, C)
        n_boxes = y_true.shape[1]
        return (agree / n_boxes * weights(y_pred)).sum(dim=-1)

    return metric
