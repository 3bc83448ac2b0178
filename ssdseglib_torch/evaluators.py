"""Post-hoc evaluators (host NumPy) — mirror of reference evaluators.py
(copy of ssdseglib_tpu/evaluators.py, pure NumPy).

The baseline numbers (BASELINE.md) depend on this module's exact — and
sometimes unusual — semantics, so they are reproduced rather than "fixed"
(SURVEY.md §7 known quirks):

- mAP counts every prediction whose best-GT IoU clears the threshold as a
  true positive; there is **no one-to-one matching**, so duplicate
  detections of one object all count as TPs (reference evaluators.py:149-157)
- AP is the trapezoidal area under the raw precision/recall points
  (np.trapz), not 11-point or COCO-style interpolation (evaluators.py:185)
- mIoU is **soft**: predicted probabilities are compared to the one-hot
  ground truth without an argmax (evaluators.py:227-235)
- box IoU uses the +1 pixel-index convention (evaluators.py:52-54)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_boxes_pred_vs_true(
    labels_pred: np.ndarray,
    boxes_pred: np.ndarray,
    labels_true: np.ndarray,
    boxes_true: np.ndarray,
) -> np.ndarray:
    """IoU of every predicted box vs every GT box, zeroed on label mismatch.

    Reference: evaluators.py:6-63.  Output (n_pred, n_true); the +1 pixel
    convention is used for all areas.
    """
    if len(labels_true) == 0:
        return np.zeros((boxes_pred.shape[0], 1), dtype=np.float32)

    label_match = (
        labels_pred[:, None] == labels_true[None, :]
    ).astype(np.float32)

    px0, py0, px1, py1 = np.split(boxes_pred, 4, axis=-1)
    tx0, ty0, tx1, ty1 = np.split(boxes_true, 4, axis=-1)

    ix0 = np.maximum(px0, tx0.T)
    iy0 = np.maximum(py0, ty0.T)
    ix1 = np.minimum(px1, tx1.T)
    iy1 = np.minimum(py1, ty1.T)

    area_pred = (px1 - px0 + 1.0) * (py1 - py0 + 1.0)
    area_true = (tx1 - tx0 + 1.0) * (ty1 - ty0 + 1.0)
    inter = np.maximum(0.0, ix1 - ix0 + 1.0) * np.maximum(0.0, iy1 - iy0 + 1.0)

    iou = inter / (area_pred + area_true.T - inter + 1e-7)
    return iou * label_match


def _load_ground_truth(path_or_arrays):
    """Accept a CSV path (reference behavior) or a (labels, boxes) tuple."""
    if isinstance(path_or_arrays, (tuple, list)) and not isinstance(
        path_or_arrays, str
    ):
        labels, boxes = path_or_arrays
        return (
            np.asarray(labels, dtype=np.int32),
            np.asarray(boxes, dtype=np.float32).reshape(-1, 4),
        )
    from ssdseglib_torch.datacoder import read_labels_boxes_csv

    return read_labels_boxes_csv(path_or_arrays)


def average_precision_object_detection(
    labels_pred_batch: np.ndarray,
    confidences_pred_batch: np.ndarray,
    boxes_pred_batch: np.ndarray,
    iou_threshold: float,
    path_files_labels_boxes: Sequence,
    labels_codes: List[int],
    label_code_background: int,
) -> Dict[int, float]:
    """Per-class average precision (reference evaluators.py:65-187).

    Args:
        labels_pred_batch: (S, K) int predicted labels per sample
        confidences_pred_batch: (S, K) float confidences
        boxes_pred_batch: (S, K, 4) corners (xmin, ymin, xmax, ymax)
        iou_threshold: TP threshold (>=)
        path_files_labels_boxes: per-sample GT — CSV paths (reference
            behavior) or (labels, boxes) tuples
    Returns:
        {label: AP} for every non-background label.
    """
    tp_conf = {l: [] for l in labels_codes if l != label_code_background}
    gt_counter = {l: 0 for l in labels_codes if l != label_code_background}

    for gt_source, labels_pred, confidences_pred, boxes_pred in zip(
        path_files_labels_boxes,
        labels_pred_batch,
        confidences_pred_batch,
        boxes_pred_batch,
    ):
        labels_true, boxes_true = _load_ground_truth(gt_source)
        for l in labels_true:
            gt_counter[int(l)] += 1

        keep = labels_pred != label_code_background
        labels_pred = labels_pred[keep]
        confidences_pred = confidences_pred[keep]
        boxes_pred = boxes_pred[keep]
        if len(labels_pred) == 0:
            continue

        iou = _iou_boxes_pred_vs_true(
            labels_pred, boxes_pred, labels_true, boxes_true
        )
        best_iou = np.max(iou, axis=1)
        true_positive = (best_iou >= iou_threshold).astype(np.int32)

        for label, conf, tp in zip(labels_pred, confidences_pred, true_positive):
            tp_conf[int(label)].append((tp, conf))

    average_precision = {}
    # np.trapezoid is np.trapz renamed (numpy 2.0); same integration as
    # the reference's np.trapz (reference evaluators.py:185).  Only touch
    # np.trapz when trapezoid is absent — on builds that removed trapz
    # entirely, an eager default argument would raise AttributeError.
    trapezoid = getattr(np, "trapezoid", None)
    if trapezoid is None:
        trapezoid = np.trapz
    for label, pairs in tp_conf.items():
        if gt_counter[label] == 0 or len(pairs) == 0:
            average_precision[label] = 0.0
            continue
        pairs = np.asarray(pairs, dtype=np.float32)
        order = np.argsort(pairs[:, 1])[::-1]
        tps = pairs[order, 0]
        precision = np.cumsum(tps) / np.arange(1, len(tps) + 1)
        recall = np.cumsum(tps) / gt_counter[label]
        average_precision[label] = float(trapezoid(y=precision, x=recall))
    return average_precision


def jaccard_iou_semantic_segmentation(
    masks_pred_batch: np.ndarray,
    path_files_masks: Sequence,
    labels_codes: List[int],
    label_code_background: int,
) -> Dict[int, float]:
    """Per-class soft IoU over a test set (reference evaluators.py:189-247).

    Args:
        masks_pred_batch: (S, H, W, C) predicted probability masks
        path_files_masks: per-sample GT — mask PNG paths (reference
            behavior) or (H, W) uint8 class-map arrays
    Returns:
        {label: IoU} for every non-background label.
    """
    from ssdseglib_torch.datacoder import decode_png_mask

    num_classes = len(labels_codes)
    masks_true = []
    for source in path_files_masks:
        if isinstance(source, str):
            class_map = decode_png_mask(open(source, "rb").read())
        else:
            class_map = np.asarray(source, dtype=np.uint8)
        masks_true.append(np.eye(num_classes, dtype=np.float32)[class_map])
    masks_true = np.asarray(masks_true, dtype=np.float32)

    intersection = np.sum(masks_true * masks_pred_batch, axis=(1, 2))
    total = np.sum(masks_true + masks_pred_batch, axis=(1, 2))
    iou = intersection / (total - intersection + 1e-7)
    iou = np.mean(iou, axis=0)

    return {
        label: float(v)
        for label, v in zip(labels_codes, iou)
        if label != label_code_background
    }
