"""Typed configuration for the framework (copy of ssdseglib_tpu/config.py).

The reference has no config system at all — configuration lives in UPPER_CASE
notebook constants (reference 03-*.ipynb cell 2) plus constructor kwargs.
Here every knob is a frozen dataclass so configs are hashable (usable as jit
static args) and self-documenting.  `reference_warehouse_config()` reproduces
the exact published training configuration (notebook 03 cells 2/6/12/14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorsConfig:
    """Default-box ("anchor") generation config.

    Mirrors the knobs of the reference `DefaultBoundingBoxes` ctor
    (reference ssdseglib/boxes.py:5-12).
    """

    feature_maps_shapes: Tuple[Tuple[int, int], ...]
    # one tuple of aspect ratios per feature map (width:height)
    feature_maps_aspect_ratios: Tuple[Tuple[float, ...], ...]
    boxes_scales: Tuple[float, float] = (0.2, 0.9)
    # one padding percentage per feature map, in [0, 0.5)
    centers_padding_from_borders: Tuple[float, ...] = ()
    additional_square_box: bool = True

    def __post_init__(self):
        n = len(self.feature_maps_shapes)
        if len(self.feature_maps_aspect_ratios) != n:
            raise ValueError("need one aspect-ratio tuple per feature map")
        if len(self.centers_padding_from_borders) != n:
            raise ValueError("need one border padding per feature map")
        for p in self.centers_padding_from_borders:
            if not 0 <= p < 0.5:
                raise ValueError("border padding must be in [0, 0.5)")

    @property
    def boxes_per_point(self) -> Tuple[int, ...]:
        extra = 1 if self.additional_square_box else 0
        return tuple(len(ars) + extra for ars in self.feature_maps_aspect_ratios)

    @property
    def total_boxes(self) -> int:
        return sum(
            h * w * b
            for (h, w), b in zip(self.feature_maps_shapes, self.boxes_per_point)
        )


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """Ground-truth encoding config (reference ssdseglib/datacoder.py:6-21)."""

    num_classes: int
    image_shape: Tuple[int, int]  # (height, width)
    iou_threshold: float = 0.5
    # (std_cx, std_cy, std_w, std_h)
    standard_deviations: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # fixed padding budget for per-sample ground-truth boxes; the reference
    # uses ragged per-sample tensors (host loop), we use fixed shapes + mask
    max_ground_truth_boxes: int = 32


@dataclasses.dataclass(frozen=True)
class NmsConfig:
    """Inference-time NMS operating point (reference notebook 03 cell 23)."""

    max_boxes_per_class: int = 4
    max_boxes_per_sample: int = 10
    iou_threshold: float = 0.025
    score_threshold: float = 0.725
    suppress_background_boxes: bool = False
    # wired through to the inference builder by callers (bench.py,
    # examples/03) — single source of truth for the cross-task gating switch
    use_segmentation_suppression: bool = True
    # Only used by the alternative method="topk" of ops.nms.combined_nms:
    # candidates per class entering the suppression scan (ops/nms_scan.py,
    # at most 1344).  That path TRUNCATES to the top K scores and diverges
    # from TF when more than K candidates clear score_threshold.  The
    # default method="exact" iterative-argmax path considers every
    # candidate and has no such bound.
    max_candidates_per_class: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model assembly config (reference ssdseglib/models.py:6-45, 425-478)."""

    input_image_shape: Tuple[int, int, int] = (480, 640, 3)
    number_of_classes: int = 4
    boxes_per_point: Tuple[int, ...] = (6, 6, 6, 6)
    backbone: str = "mobilenetv2"  # or "shufflenetv2", "mobilenetv3_large"
    segmentation_dilation_rates: Tuple[int, int, int] = (6, 12, 18)
    # shufflenet-only knobs (reference models.py:429-470)
    shufflenet_size: str = "1x"  # '0.5x' | '1x' | '1.5x' | '2x'
    shufflenet_extra_depthwise: bool = False
    shufflenet_residuals: bool = False
    # reference quirk knob: reference heads use ReLU(max_value=0.0) on the
    # shufflenet path which zeroes activations in Keras (blocks.py:154 with
    # relu_max_value default 0.0); we treat relu_max<=0 as an uncapped ReLU
    # and document the deviation instead of silently zeroing the network.
    #
    # detection_head_relu_max: relu cap of the SSDLite head blocks ONLY.
    # None = the backbone default (6.0 on mobilenetv2 — the reference
    # applies ReLU6 to the classification logits BEFORE the softmax,
    # models.py:259, so confidence saturates at e^6/(e^6+C-1) with zero
    # gradient beyond the cap; a documented dead-channel / tied-score
    # pathology, docs/PERFORMANCE.md).  0.0 = uncapped ReLU — a framework
    # extension that removes the pathology; breaks weight-for-weight
    # parity with the published checkpoint, so it is opt-in.
    detection_head_relu_max: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe (reference notebook 03 cells 2/14/16)."""

    batch_size: int = 16
    learning_rate: float = 1e-4
    epochs: int = 105
    seed: int = 1993
    loss_weight_mask: float = 1.0
    loss_weight_labels: float = 1.0
    loss_weight_boxes: float = 1.0
    mask_class_weights: Tuple[float, ...] = (0.05, 0.575, 0.135, 0.24)
    mask_loss: str = "cross_entropy"  # 'cross_entropy' | 'dice' | 'dice_square'
    augmentation_horizontal_flip: bool = True
    augmentation_rgb: bool = True
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 1000
    # 'bfloat16' = mixed-precision training: f32 master params/optimizer,
    # bf16 forward/backward on the MXU, f32 losses.  bf16 shares f32's
    # exponent range so no loss scaling is needed.
    compute_dtype: str = "float32"
    # hard-negative budget of the confidence loss as a multiple of the
    # positive count; 3.0 = the reference's exact behavior, None = every
    # background anchor contributes (framework extension — see
    # losses.confidence_loss)
    hnm_negatives_ratio: Optional[float] = 3.0
    # learning-rate schedule: 'constant' (the reference recipe) or
    # 'warmup_cosine' (linear warmup over lr_warmup_steps to
    # learning_rate, cosine decay to lr_final over lr_total_steps)
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_total_steps: Optional[int] = None
    lr_final: float = 0.0
    # store Adam's first moment in bf16 (optax mu_dtype): halves the
    # larger optimizer-state buffer with negligible update error (the
    # second moment stays f32 — its ratio semantics need the mantissa)
    adam_mu_dtype: str = "float32"
    # rematerialize the forward during backward (jax.checkpoint): trades
    # ~30% more FLOPs for not storing the 480x640-resolution mask-head
    # activations — useful for large batches / long schedules
    remat: bool = False
    # streaming metrics computed inside the jitted train/eval steps:
    # 'full' = the reference's per-step Keras metrics (C20: soft mask IoU,
    # decoded-box IoU over all 9600 anchors, per-class accuracy — notebook
    # 03 cell 14), 'loss_only' = just the 4 loss scalars (framework
    # extension: the metric ops cost measurable step time; the post-hoc
    # evaluators C21/C22 are unaffected)
    streaming_metrics: str = "full"


def reference_warehouse_config():
    """The exact published configuration of the reference training run.

    Sources: reference notebook 03 cells 2 (shapes/classes/stds/batch),
    6 (anchors + iou threshold), 12 (dilations (3, 6, 12)), 14 (lr, weights).
    """
    anchors = AnchorsConfig(
        feature_maps_shapes=((30, 40), (15, 20), (8, 10), (4, 5)),
        feature_maps_aspect_ratios=((1.0, 2.0, 3.0, 1 / 2, 1 / 3),) * 4,
        boxes_scales=(0.15, 0.95),
        centers_padding_from_borders=(0.025, 0.05, 0.075, 0.1),
        additional_square_box=True,
    )
    encoding = EncodingConfig(
        num_classes=4,
        image_shape=(480, 640),
        iou_threshold=0.525,
        standard_deviations=(0.1, 0.1, 0.2, 0.2),
    )
    model = ModelConfig(
        input_image_shape=(480, 640, 3),
        number_of_classes=4,
        boxes_per_point=anchors.boxes_per_point,
        backbone="mobilenetv2",
        segmentation_dilation_rates=(3, 6, 12),
    )
    nms = NmsConfig()
    train = TrainConfig()
    return anchors, encoding, model, nms, train
