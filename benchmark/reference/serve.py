"""Reference post-processing and the serving comparison.

Anchors, box decoding, the segmentation suppression and greedy NMS written
from the reference's description (SSD anchors with the +1 pixel-index
convention, ``log(w / w_anchor + 1)`` offsets, class presence over the whole
batch, TF's combined NMS), and the numbers that judge a served batch:

- ``mask_mean_abs`` / ``mask_max_abs``: mean and largest |difference| of the
  served mask's probabilities from the reference's;
- ``det_box_px``: the largest distance (pixels, L-inf over the four corners)
  from a served box to the reference's box of the anchor it stands for (the
  anchor nearest to the row by relative box distance plus score), and
  ``det_box_rel`` the largest such distance over the reference box's larger
  side plus 16 pixels: decoding raises the offsets' errors to an
  exponential, so large boxes carry large absolute errors;
- ``det_gap``: NMS followed along the served rows (teacher forcing, as a
  served token is judged by the reference's logits): for each served row,
  how far its reference score lies below the best candidate the reference
  still had, and for each class that stopped early, how far the best
  candidate left lies above the threshold (or above the lowest served row
  where the batch was cut at its row budget).  Candidates that overlap a
  served row's box at all but not past the NMS IoU threshold stay in the
  reference's NMS and are left out of both gaps: at the configurations'
  threshold of 0.025 their suppression turns on a pixel or two of box
  rounding (an f32 IoU of 0.017 is suppressed in bf16), so a bf16 program
  may drop them or keep them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# a served row stands for the anchor whose reference box and score lie
# nearest: box distance over (the box's larger side + SIDE_FLOOR_PX), plus
# score difference over SCORE_SCALE.  The floor keeps boxes that decode to
# (almost) no width from making every near miss look far.
SIDE_FLOOR_PX = 16.0
SCORE_SCALE = 0.05

import numpy as np
import torch


def anchors(anchors_cfg: Dict, image_hw) -> Tuple[np.ndarray, np.ndarray]:
    """(corners (N, 4) xmin ymin xmax ymax, centroids (N, 4) cx cy w h), f32."""
    shapes = [tuple(s) for s in anchors_cfg["feature_maps_shapes"]]
    scales = np.linspace(*anchors_cfg["boxes_scales"], len(shapes) + 1)
    per_map = []
    for i, (fm, ratios, pad) in enumerate(zip(shapes, anchors_cfg["feature_maps_aspect_ratios"],
                                              anchors_cfg["centers_padding_from_borders"])):
        size = min(fm)
        hw = [(size * scales[i] / math.sqrt(r), size * scales[i] * math.sqrt(r)) for r in ratios]
        if anchors_cfg["additional_square_box"]:
            side = size * math.sqrt(scales[i] * scales[i + 1])
            hw.append((side, side))
        hw = np.asarray(hw, np.float64)

        def centers(n):
            return np.array([0.5]) if n == 1 else np.linspace(pad * (n - 1.0), n - 1.0 - pad * (n - 1.0), n)

        cy, cx = centers(fm[0])[:, None, None], centers(fm[1])[None, :, None]
        half_w, half_h = (hw[None, None, :, 1] - 1.0) / 2.0, (hw[None, None, :, 0] - 1.0) / 2.0
        boxes = np.stack(np.broadcast_arrays(cx - half_w, cy - half_h, cx + half_w, cy + half_h),
                         -1).astype(np.float32)
        fx = (image_hw[1] - 1) / (fm[1] - 1 if fm[1] > 1 else 1)
        fy = (image_hw[0] - 1) / (fm[0] - 1 if fm[0] > 1 else 1)
        per_map.append((boxes * np.array([fx, fy, fx, fy], np.float32)).reshape(-1, 4))
    corners = np.concatenate(per_map).astype(np.float32)
    x0, y0, x1, y1 = corners.T
    centroids = np.stack([(x1 + x0) / 2, (y1 + y0) / 2, x1 - x0 + 1, y1 - y0 + 1], -1)
    return corners, centroids.astype(np.float32)


def decode_yx(offsets: torch.Tensor, centroids: torch.Tensor, stds) -> torch.Tensor:
    """Predicted offsets (..., N, 4) -> corners (ymin, xmin, ymax, xmax)."""
    acx, acy, aw, ah = centroids.unbind(-1)
    cx = offsets[..., 0] * stds[0] * aw + acx
    cy = offsets[..., 1] * stds[1] * ah + acy
    w = (torch.exp(offsets[..., 2] * stds[2]) - 1.0) * aw
    h = (torch.exp(offsets[..., 3] * stds[3]) - 1.0) * ah
    return torch.stack([cy - (h - 1) / 2, cx - (w - 1) / 2, cy + (h - 1) / 2, cx + (w - 1) / 2], -1)


def presence(mask: torch.Tensor, classes: int = 4) -> torch.Tensor:
    """(classes,) bool: which classes the argmax of a batch's mask holds."""
    pred = mask.argmax(dim=-1).reshape(-1)
    return torch.bincount(pred, minlength=classes)[:classes] > 0


def _iou_one(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one (4,) box with (N, 4) boxes, (y, x) corners canonicalised,
    no +1 (TF's NMS); 0 where the union is not positive."""
    def canon(b):
        return (torch.minimum(b[..., 0], b[..., 2]), torch.minimum(b[..., 1], b[..., 3]),
                torch.maximum(b[..., 0], b[..., 2]), torch.maximum(b[..., 1], b[..., 3]))
    y0, x0, y1, x1 = canon(boxes)
    sy0, sx0, sy1, sx1 = canon(box)
    inter = ((torch.minimum(sy1, y1) - torch.maximum(sy0, y0)).clamp(min=0)
             * (torch.minimum(sx1, x1) - torch.maximum(sx0, x0)).clamp(min=0))
    union = (sy1 - sy0) * (sx1 - sx0) + (y1 - y0) * (x1 - x0) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def judge_detections(rows: torch.Tensor, scores: torch.Tensor, boxes_yx: torch.Tensor,
                     nms: Dict) -> Tuple[float, float, float, int]:
    """(det_gap, det_box_px, det_box_rel, rows judged) of one sample.

    rows: (T, 6) served [label, score, xmin, ymin, xmax, ymax], zero rows
    last; scores: (N, C) the reference's gated probabilities; boxes_yx:
    (N, 4) the reference's decoded boxes, on the same device (f32)."""
    thr, iou_thr = nms["score_threshold"], nms["iou_threshold"]
    per_class, budget = nms["max_boxes_per_class"], nms["max_boxes_per_sample"]
    valid = rows[:, 1] > 0
    served = rows[valid]
    gap, box_px, box_rel = 0.0, 0.0, 0.0
    cut = bool(valid.sum() >= budget)
    lowest = float(served[:, 1].min()) if len(served) else thr
    sides = (boxes_yx[:, 2:] - boxes_yx[:, :2]).abs().amax(dim=-1) + SIDE_FLOOR_PX
    for c in range(scores.shape[1]):
        avail = scores[:, c] > thr
        # candidates whose suppression turns on rounding: overlapping a
        # served row's box, not past the threshold
        touching = torch.zeros_like(avail)
        mine = served[served[:, 0] == c]
        for row in mine:
            box = torch.stack([row[3], row[2], row[5], row[4]])
            dist = (boxes_yx - box).abs().amax(dim=-1)
            rel = dist / sides
            # the anchor the row stands for: nearest by box and score together
            j = int((rel + (scores[:, c] - row[1]).abs() / SCORE_SCALE).argmin())
            box_px = max(box_px, float(dist[j]))
            box_rel = max(box_rel, float(rel[j]))
            clear = avail & ~touching
            best = float(scores[clear, c].max()) if bool(clear.any()) else thr
            gap = max(gap, best - float(scores[j, c]))
            iou = _iou_one(boxes_yx[j], boxes_yx)
            avail &= ~(iou > iou_thr)
            avail[j] = False
            touching |= iou > 0
        clear = avail & ~touching
        if len(mine) < per_class and bool(clear.any()):
            left = float(scores[clear, c].max())
            gap = max(gap, left - (lowest if cut else thr))
    return gap, box_px, box_rel, int(len(served))


def judge_batch(served_mask: torch.Tensor, served_det: torch.Tensor, ref_mask: torch.Tensor,
                ref_labels: torch.Tensor, ref_boxes: torch.Tensor, centroids: torch.Tensor,
                stds, nms: Dict) -> Dict[str, float]:
    """The numbers of one served batch against the reference's raw outputs
    of the same images (f32, on one device).  The gating follows the served
    mask's class presence; the mask numbers judge the mask itself."""
    diff = (served_mask.float() - ref_mask).abs()
    gated = ref_labels * presence(served_mask.float(), ref_labels.shape[-1]).to(ref_labels.dtype)
    boxes = decode_yx(ref_boxes, centroids, stds)
    gap = box_px = box_rel = 0.0
    rows = 0
    for b in range(served_det.shape[0]):
        g, p, r, n = judge_detections(served_det[b].float(), gated[b], boxes[b], nms)
        gap, box_px, box_rel, rows = max(gap, g), max(box_px, p), max(box_rel, r), rows + n
    return {"mask_mean_abs": float(diff.mean()), "mask_max_abs": float(diff.max()),
            "det_gap": gap, "det_box_px": box_px, "det_box_rel": box_rel, "rows": rows,
            "presence_differs": int((presence(served_mask.float()) != presence(ref_mask)).sum())}


def nms_rows(scores: torch.Tensor, boxes_yx: torch.Tensor, nms: Dict) -> torch.Tensor:
    """Greedy per-class NMS of one sample, then the classes' selections
    class-major, stably sorted by score, cut at the row budget: (T, 6)
    [label, score, xmin, ymin, xmax, ymax], zero rows last."""
    picked = []
    for c in range(scores.shape[1]):
        avail = scores[:, c] > nms["score_threshold"]
        for _ in range(nms["max_boxes_per_class"]):
            if not bool(avail.any()):
                break
            j = int(torch.where(avail, scores[:, c], torch.full_like(scores[:, c], -1.0)).argmax())
            picked.append((c, float(scores[j, c]), boxes_yx[j]))
            avail &= ~(_iou_one(boxes_yx[j], boxes_yx) > nms["iou_threshold"])
            avail[j] = False
    picked = sorted(picked, key=lambda p: -p[1])[: nms["max_boxes_per_sample"]]
    out = torch.zeros(nms["max_boxes_per_sample"], 6, dtype=torch.float32, device=scores.device)
    for i, (c, s, b) in enumerate(picked):
        out[i] = torch.stack([b.new_tensor(float(c)), b.new_tensor(s), b[1], b[0], b[3], b[2]])
    return out


def serve_reference(mask: torch.Tensor, labels: torch.Tensor, offsets: torch.Tensor,
                    centroids: torch.Tensor, stds, nms: Dict) -> torch.Tensor:
    """(B, T, 6) detections of a batch from the network's raw outputs."""
    gated = labels * presence(mask, labels.shape[-1]).to(labels.dtype)
    boxes = decode_yx(offsets, centroids, stds)
    return torch.stack([nms_rows(gated[b], boxes[b], nms) for b in range(len(gated))])
