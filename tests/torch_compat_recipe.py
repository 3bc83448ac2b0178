"""Notebook 03's facade recipe at 96x128, shared by both sides of
tests/test_torch_compat.py: the port's facade (``ssdseglib_torch.compat``)
in the test process and the JAX package's (``ssdseglib``) in a subprocess
(tests/torch_compat_jax_side.py).  Each function takes the facade package as
its argument and imports neither, so both sides build, compile and feed their
facade with the same code and the same NumPy arrays.
"""

from __future__ import annotations

import numpy as np

INPUT_IMAGE_SHAPE = (96, 128, 3)
STDS = (0.1, 0.1, 0.2, 0.2)
DILATIONS = (3, 6, 12)
LEARNING_RATE = 1e-4
EPOCHS = 2
BATCH = 2
# an operating point where the trained random model keeps detections
SERVE = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
             boxes_iou_threshold=0.5, labels_probability_threshold=0.05,
             use_segmentation_suppression=True)


def default_boxes(ssdseglib):
    """(the default boxes as the builders and the box metric take them, the
    boxes per point) (reference notebook 03 cell 6)."""
    boxes = ssdseglib.boxes.DefaultBoundingBoxes(
        feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
        centers_padding_from_borders_percentage=(0.025, 0.05, 0.075, 0.1),
        boxes_scales=(0.2, 0.9),
        additional_square_box=True,
    )
    boxes.rescale_boxes_coordinates(image_shape=INPUT_IMAGE_SHAPE[:2])
    style = dict(coordinates_style="ssd")
    return dict(
        center_x_boxes_default=boxes.get_boxes_coordinates_center_x(**style),
        center_y_boxes_default=boxes.get_boxes_coordinates_center_y(**style),
        width_boxes_default=boxes.get_boxes_coordinates_width(**style),
        height_boxes_default=boxes.get_boxes_coordinates_height(**style),
        standard_deviations_centroids_offsets=STDS,
    ), [len(ratios) + 1 for ratios in boxes.feature_maps_aspect_ratios]


def n_anchors(ssdseglib) -> int:
    return len(default_boxes(ssdseglib)[0]["center_x_boxes_default"])


def builder(ssdseglib):
    kwargs, boxes_per_point = default_boxes(ssdseglib)
    return ssdseglib.models.MobileNetV2SsdSegBuilder(
        input_image_shape=INPUT_IMAGE_SHAPE, number_of_boxes_per_point=boxes_per_point,
        number_of_classes=4, **kwargs)


def compile_like_the_notebook(ssdseglib, model) -> None:
    """Notebook 03 cell 14's loss, weight and metric dicts, in f32."""
    kwargs, _ = default_boxes(ssdseglib)
    weights = (0.05, 0.575, 0.135, 0.24)
    model.compile(
        optimizer=LEARNING_RATE,
        loss={
            "output-mask": ssdseglib.losses.cross_entropy(classes_weights=weights),
            "output-labels": ssdseglib.losses.confidence_loss,
            "output-boxes": ssdseglib.losses.localization_loss,
        },
        loss_weights={"output-mask": 1.0, "output-labels": 1.0, "output-boxes": 1.0},
        metrics={
            "output-mask": ssdseglib.metrics.jaccard_iou_segmentation_masks(
                classes_weights=weights),
            "output-labels": ssdseglib.metrics.categorical_accuracy(
                classes_weights=(0.0, 1 / 3, 1 / 3, 1 / 3)),
            "output-boxes": ssdseglib.metrics.jaccard_iou_bounding_boxes(**kwargs),
        },
        compute_dtype="float32",
    )


def packed_batches(n_anchors: int, seed: int = 0):
    """Two fixed batches on the packed wire without the color jitter: uint8
    images, uint8 class maps, uint8 label indices (a quarter of the anchors
    positive), f32 offsets."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(2):
        h, w = INPUT_IMAGE_SHAPE[:2]
        labels = np.where(rng.uniform(size=(BATCH, n_anchors)) < 0.25,
                          rng.integers(1, 4, (BATCH, n_anchors)), 0).astype(np.uint8)
        boxes = (rng.normal(0, 0.5, (BATCH, n_anchors, 4)) * (labels > 0)[..., None])
        batches.append((
            rng.integers(0, 256, (BATCH, h, w, 3), dtype=np.uint8),
            {"output-mask": rng.integers(0, 4, (BATCH, h, w), dtype=np.uint8),
             "output-labels": labels,
             "output-boxes": boxes.astype(np.float32)},
        ))
    return batches


def eval_images(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH,) + INPUT_IMAGE_SHAPE).astype(np.float32)


def wire_cases(seed: int = 2):
    """(name, images, targets) host batches for the packing helpers: f32
    one-hot targets with integer and non-integer images, a not-one-hot mask,
    uint8 one-hot targets (the rank guard), and a pre-packed batch with a
    jitter seed."""
    rng = np.random.default_rng(seed)
    eye = np.eye(4, dtype=np.float32)
    mask_map = rng.integers(0, 4, (2, 8, 8))
    label_map = rng.integers(0, 4, (2, 5))
    boxes = rng.normal(size=(2, 5, 4)).astype(np.float32)
    one_hot = {"output-mask": eye[mask_map], "output-labels": eye[label_map],
               "output-boxes": boxes}
    soft = dict(one_hot, **{"output-mask": eye[mask_map] * 0.5})
    integer_images = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.float32)
    return [
        ("one-hot f32, integer images", integer_images, one_hot),
        ("one-hot f32, float images", integer_images + 0.25, one_hot),
        ("soft mask", integer_images, soft),
        ("uint8 one-hot", integer_images.astype(np.uint8),
         {k: v.astype(np.uint8) if k != "output-boxes" else v for k, v in one_hot.items()}),
        ("pre-packed, seeded", integer_images.astype(np.uint8),
         {"output-mask": mask_map.astype(np.uint8), "output-labels": label_map.astype(np.uint8),
          "output-boxes": boxes, "__ssdseglib-color-aug-seed__": np.int32(424242)}),
    ]
