"""Inference-path layers (PyTorch), counterparts of ssdseglib_tpu/layers.py
(reference ssdseglib/layers.py).  Plain callables over tensors; the
constructor arguments mirror the reference layer constructors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ssdseglib_torch.config import NmsConfig
from ssdseglib_torch.ops import nms as nms_ops
from ssdseglib_torch.ops.encoding import decode_predictions_to_corners_yx
from ssdseglib_torch.parallel.mesh import active_groups, all_reduce_


class DecodeBoxesCentroidsOffsets:
    """Decode predicted centroid offsets to (ymin, xmin, ymax, xmax) corners
    (reference ssdseglib/layers.py:5-93).  The anchors are held as an
    (N, 4) float32 (cx, cy, w, h) tensor on the CPU; move them to the
    device of the predictions with `to`."""

    def __init__(
        self,
        center_x_boxes_default,
        center_y_boxes_default,
        width_boxes_default,
        height_boxes_default,
        standard_deviation_center_x_offsets: float,
        standard_deviation_center_y_offsets: float,
        standard_deviation_width_offsets: float,
        standard_deviation_height_offsets: float,
    ) -> None:
        self.anchors_centroids = torch.stack(
            [
                torch.as_tensor(v, dtype=torch.float32)
                for v in (center_x_boxes_default, center_y_boxes_default,
                          width_boxes_default, height_boxes_default)
            ],
            dim=-1,
        )
        self.standard_deviations = (
            float(standard_deviation_center_x_offsets),
            float(standard_deviation_center_y_offsets),
            float(standard_deviation_width_offsets),
            float(standard_deviation_height_offsets),
        )

    def to(self, device) -> "DecodeBoxesCentroidsOffsets":
        self.anchors_centroids = self.anchors_centroids.to(device)
        return self

    def __call__(self, boxes_centroids_offsets: torch.Tensor) -> torch.Tensor:
        return decode_predictions_to_corners_yx(
            boxes_centroids_offsets, self.anchors_centroids,
            self.standard_deviations,
        )


class NonMaximumSuppression:
    """Combined NMS + output formatting (reference ssdseglib/layers.py:96-177).
    Output rows are ``[label, probability, xmin, ymin, xmax, ymax]`` with
    shape (batch, max_boxes_per_sample, 6), zero padded.

    ``suppress_background_boxes=True`` reproduces the reference's
    batch-flattening boolean mask (layers.py:165-166); the output becomes
    ragged, so that step synchronises with the host."""

    def __init__(
        self,
        max_number_of_boxes_per_class: int,
        max_number_of_boxes_per_sample: int,
        boxes_iou_threshold: float,
        labels_probability_threshold: float,
        suppress_background_boxes: bool = False,
    ) -> None:
        self.config = NmsConfig(
            max_boxes_per_class=max_number_of_boxes_per_class,
            max_boxes_per_sample=max_number_of_boxes_per_sample,
            iou_threshold=boxes_iou_threshold,
            score_threshold=labels_probability_threshold,
            suppress_background_boxes=suppress_background_boxes,
        )

    def __call__(
        self,
        boxes_corners_coordinates: torch.Tensor,
        labels_probabilities: torch.Tensor,
        iou_threshold=None,
        score_threshold=None,
    ) -> torch.Tensor:
        """Args: boxes (B, N, 4) in (ymin, xmin, ymax, xmax); scores
        (B, N, C).  The threshold overrides may be 0-d device tensors
        (runtime-tunable operating point, no host sync)."""
        out = nms_ops.combined_nms(
            boxes_corners_coordinates,
            labels_probabilities,
            self.config,
            iou_threshold=iou_threshold,
            score_threshold=score_threshold,
        )
        # reorder to (xmin, ymin, xmax, ymax) like the reference (layers.py:155);
        # slices, not a list index, which would upload an index tensor
        boxes = out["boxes"]
        detections = torch.stack(
            [out["classes"], out["scores"], boxes[..., 1], boxes[..., 0],
             boxes[..., 3], boxes[..., 2]],
            dim=-1,
        )
        if self.config.suppress_background_boxes:
            return detections[detections[..., 0] > 0.0]
        return detections


class SegmentationSuppression:
    """Cross-task gating of detection probabilities by the segmentation mask
    (reference ssdseglib/layers.py:180-212), with its two quirks kept for
    metric parity: class presence is reduced over the **whole batch** and
    the one-hot depth defaults to 4.  Inside a `parallel.mesh.data_parallel`
    scope the whole batch is the global batch, all of its rows: one MAX
    all_reduce of the (num_classes,) presence vector over the whole mesh."""

    def __init__(self, num_classes: int = 4) -> None:
        self.num_classes = num_classes

    def __call__(
        self, segmentation_mask: torch.Tensor, labels_probabilities: torch.Tensor
    ) -> torch.Tensor:
        pred = segmentation_mask.argmax(dim=-1)  # first index on ties
        classes = torch.arange(self.num_classes, device=pred.device)
        present = (pred.reshape(-1, 1) == classes).any(dim=0)
        groups = active_groups()
        if groups is not None:
            present = all_reduce_(present.to(torch.float32), groups.whole,
                                  dist.ReduceOp.MAX) > 0
        return labels_probabilities * present.to(labels_probabilities.dtype)


class Split:
    """Split along one axis (reference ssdseglib/layers.py:215-244, without
    its ``get_config`` attribute typo): ``num_or_size_splits`` equal parts,
    or parts of the listed sizes; ``num`` is kept for the reference's
    signature and not read."""

    def __init__(self, num_or_size_splits, axis: int, num: int = None) -> None:
        self.num_or_size_splits = num_or_size_splits
        self.axis = axis
        self.num = num

    def __call__(self, value: torch.Tensor):
        if isinstance(self.num_or_size_splits, int):
            if value.shape[self.axis] % self.num_or_size_splits:
                raise ValueError(
                    f"axis {self.axis} of shape {tuple(value.shape)} does not split into "
                    f"{self.num_or_size_splits} equal parts"
                )
            return list(value.chunk(self.num_or_size_splits, dim=self.axis))
        return list(value.split(list(self.num_or_size_splits), dim=self.axis))
