"""Offset decoding (PyTorch), counterpart of the decode half of
ssdseglib_tpu/ops/encoding.py (reference ssdseglib/datacoder.py:349-432 and
layers.py:45-81).  The ground-truth encoder is training-side and not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssdseglib_torch.boxes import coordinates_centroids_to_corners


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
