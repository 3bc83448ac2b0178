"""Ground-truth encoding and offset decoding (PyTorch), counterpart of
ssdseglib_tpu/ops/encoding.py (reference ssdseglib/datacoder.py:177-300,
:349-432 and layers.py:45-81).

The ground truth is padded to a fixed ``max_ground_truth_boxes`` budget with
a validity mask and the whole encoder is branch-free batched tensor math on
the device of its inputs.  Matching semantics of the reference:

- step 1: every ground-truth box claims its best-IoU anchor (kept if IoU > 0)
- step 2: every anchor claims its best-IoU ground truth (kept if
  IoU > iou_threshold, strictly)
- conflicts: for an anchor claimed by both, the anchor-side claim wins;
  among several gt-side claims on one anchor the highest gt index wins.

The non-standard offset transform ``log(w_gt / w_anchor + 1)`` is kept for
checkpoint parity, as is the +1 pixel-index convention in every area and
width.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ssdseglib_torch.boxes import (
    Anchors,
    coordinates_centroids_to_corners,
    coordinates_corners_to_centroids,
)
from ssdseglib_torch.config import EncodingConfig


def iou_matrix(anchors_corners: torch.Tensor, gt_corners: torch.Tensor) -> torch.Tensor:
    """IoU between every anchor and every ground-truth box.

    Args:
        anchors_corners: (N, 4) as (xmin, ymin, xmax, ymax)
        gt_corners: (..., G, 4) same layout
    Returns:
        (..., N, G) IoU with the +1 pixel-index convention.
    """
    ax0, ay0, ax1, ay1 = (anchors_corners[:, i, None] for i in range(4))  # (N, 1)
    gx0, gy0, gx1, gy1 = (gt_corners[..., None, :, i] for i in range(4))  # (..., 1, G)

    inter_w = (torch.minimum(ax1, gx1) - torch.maximum(ax0, gx0) + 1.0).clamp_min(0.0)
    inter_h = (torch.minimum(ay1, gy1) - torch.maximum(ay0, gy0) + 1.0).clamp_min(0.0)
    inter = inter_w * inter_h

    area_a = (ax1 - ax0 + 1.0) * (ay1 - ay0 + 1.0)
    area_g = (gx1 - gx0 + 1.0) * (gy1 - gy0 + 1.0)
    return inter / (area_a + area_g - inter)


def match_anchors(iou: torch.Tensor, gt_valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Anchor-to-ground-truth assignment.

    Args:
        iou: (..., N, G) IoU matrix
        gt_valid: (..., G) bool validity of each padded ground-truth slot
        iou_threshold: anchor-side match threshold (strict >)
    Returns:
        (..., N) int64 assigned gt index per anchor, -1 for background.
    """
    n, g = iou.shape[-2:]
    neg = torch.where(gt_valid[..., None, :], iou, iou.new_tensor(-1.0))

    # gt-side claims: each valid gt with max IoU > 0 claims its argmax anchor
    # (ties to the lowest anchor); on a collision the highest gt index wins
    best_anchor_per_gt = iou.argmax(dim=-2)  # (..., G)
    gt_claim_valid = gt_valid & (neg.amax(dim=-2) > 0.0)
    gt_idx = torch.arange(g, device=iou.device)
    n_idx = torch.arange(n, device=iou.device)
    claims = best_anchor_per_gt[..., :, None] == n_idx  # (..., G, N)
    assigned = torch.where(
        claims & gt_claim_valid[..., :, None], gt_idx[:, None], gt_idx.new_tensor(-1)
    ).amax(dim=-2)

    # anchor-side claims override (ties to the lowest gt index)
    best_gt_per_anchor = neg.argmax(dim=-1)  # (..., N)
    anchor_claim_valid = neg.amax(dim=-1) > iou_threshold
    return torch.where(anchor_claim_valid, best_gt_per_anchor, assigned)


def encode_sample(
    gt_labels: torch.Tensor,
    gt_boxes_corners: torch.Tensor,
    gt_valid: torch.Tensor,
    anchors_corners: torch.Tensor,
    *,
    num_classes: int,
    iou_threshold: float,
    standard_deviations: Tuple[float, float, float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ground truth into SSD training targets; any leading batch
    dimensions are carried through.

    Args:
        gt_labels: (..., G) int class labels (0 reserved for background)
        gt_boxes_corners: (..., G, 4) corners (xmin, ymin, xmax, ymax)
        gt_valid: (..., G) bool mask for padded slots
        anchors_corners: (N, 4) anchor corners
    Returns:
        labels: (..., N, num_classes) one-hot (background = class 0)
        offsets: (..., N, 4) standardized centroid offsets, zero for background
    """
    std_cx, std_cy, std_w, std_h = (float(s) for s in standard_deviations)

    iou = iou_matrix(anchors_corners, gt_boxes_corners)
    assigned = match_anchors(iou, gt_valid, iou_threshold)
    matched = assigned >= 0
    safe = assigned.clamp_min(0)

    # row selection from the (G, .) ground-truth tables by index: exact
    labels_matched = torch.gather(gt_labels.long(), -1, safe)
    labels = F.one_hot(
        torch.where(matched, labels_matched, torch.zeros_like(labels_matched)),
        num_classes,
    ).to(torch.float32)

    acx, acy, aw, ah = coordinates_corners_to_centroids(*anchors_corners.unbind(-1))
    g = torch.gather(gt_boxes_corners, -2, safe[..., None].expand(*safe.shape, 4))
    gcx, gcy, gw, gh = coordinates_corners_to_centroids(*g.unbind(-1))
    off = torch.stack(
        [
            (gcx - acx) / aw / std_cx,
            (gcy - acy) / ah / std_cy,
            torch.log(gw / aw + 1.0) / std_w,
            torch.log(gh / ah + 1.0) / std_h,
        ],
        dim=-1,
    )
    offsets = torch.where(matched[..., None], off, torch.zeros_like(off))
    return labels, offsets


def make_batch_encoder(anchors: Anchors, cfg: EncodingConfig, device="cuda") -> Callable:
    """Build a batched encoder closed over the anchor constants on ``device``.

    Returns a function (gt_labels (B, G), gt_boxes (B, G, 4), gt_valid (B, G))
    -> (labels (B, N, C), offsets (B, N, 4)), taking tensors or NumPy arrays
    and computing on ``device``.
    """
    device = torch.device(device)
    anchors_corners = torch.from_numpy(anchors.corners.copy()).to(device)

    @torch.no_grad()
    def encode_batch(gt_labels, gt_boxes_corners, gt_valid):
        return encode_sample(
            torch.as_tensor(gt_labels).to(device, torch.int64),
            torch.as_tensor(gt_boxes_corners).to(device, torch.float32),
            torch.as_tensor(gt_valid).to(device, torch.bool),
            anchors_corners,
            num_classes=cfg.num_classes,
            iou_threshold=cfg.iou_threshold,
            standard_deviations=cfg.standard_deviations,
        )

    return encode_batch


# ---------------------------------------------------------------------------
# offset decoding
# ---------------------------------------------------------------------------


def decode_offsets_to_centroids(
    offsets: torch.Tensor,
    anchors_centroids: torch.Tensor,
    standard_deviations: Tuple[float, float, float, float],
    zero_background: bool = True,
) -> torch.Tensor:
    """Decode standardized centroid offsets back to centroid coordinates:
    ``c = off * std * anchor_size + anchor_center`` and
    ``size = (exp(off * std) - 1) * anchor_size``.

    Args:
        offsets: (..., N, 4) standardized offsets
        anchors_centroids: (N, 4) as (cx, cy, w, h)
        zero_background: rows whose offsets are all zero (the encoder's
            background marker) decode to all-zero coordinates
    Returns:
        (..., N, 4) centroids (cx, cy, w, h)
    """
    # the stds multiply as Python scalars: a (4,) device tensor built here
    # would be a host->device copy on every call
    acx, acy, aw, ah = anchors_centroids.unbind(-1)
    sx, sy, sw, sh = (float(s) for s in standard_deviations)
    cx = offsets[..., 0] * sx * aw + acx
    cy = offsets[..., 1] * sy * ah + acy
    w = (torch.exp(offsets[..., 2] * sw) - 1.0) * aw
    h = (torch.exp(offsets[..., 3] * sh) - 1.0) * ah
    out = torch.stack([cx, cy, w, h], dim=-1)
    if zero_background:
        not_background = offsets.abs().sum(dim=-1, keepdim=True) > 0.0
        out = out * not_background.to(out.dtype)
    return out


def decode_predictions_to_corners_yx(
    offsets: torch.Tensor,
    anchors_centroids: torch.Tensor,
    standard_deviations: Tuple[float, float, float, float],
) -> torch.Tensor:
    """Decode *network-predicted* offsets to (ymin, xmin, ymax, xmax)
    corners: no background zeroing, output in the (y, x) order the NMS
    stage consumes."""
    cent = decode_offsets_to_centroids(
        offsets, anchors_centroids, standard_deviations, zero_background=False
    )
    xmin, ymin, xmax, ymax = coordinates_centroids_to_corners(
        cent[..., 0], cent[..., 1], cent[..., 2], cent[..., 3]
    )
    return torch.stack([ymin, xmin, ymax, xmax], dim=-1)
