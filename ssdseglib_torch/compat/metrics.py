"""Alias of `ssdseglib_torch.metrics` with the reference factory signatures,
the port's counterpart of ssdseglib/metrics.py.

`jaccard_iou_segmentation_masks` and `categorical_accuracy` already share
the reference signature (classes_weights).  The decoded-box IoU factory is
re-wrapped here because the reference passes the default-box centroids as
four keyword arrays (reference metrics.py:53-77; notebook 03 cell 10),
while the port's implementation takes an `Anchors` bundle.
"""

import numpy as np

import ssdseglib_torch.metrics as _impl
from ssdseglib_torch.boxes import Anchors, coordinates_centroids_to_corners

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)


def jaccard_iou_bounding_boxes(
    center_x_boxes_default,
    center_y_boxes_default,
    width_boxes_default,
    height_boxes_default,
    standard_deviations_centroids_offsets,
):
    """Decoded-box IoU metric factory with the reference keyword surface
    (reference metrics.py:53-173; notebook 03 cell 10)."""
    centroids = [
        np.asarray(a, np.float32)
        for a in (
            center_x_boxes_default,
            center_y_boxes_default,
            width_boxes_default,
            height_boxes_default,
        )
    ]
    anchors = Anchors(
        corners=np.stack(coordinates_centroids_to_corners(*centroids), axis=-1),
        centroids=np.stack(centroids, axis=-1),
    )
    return _impl.jaccard_iou_bounding_boxes(
        anchors, tuple(float(s) for s in standard_deviations_centroids_offsets)
    )
