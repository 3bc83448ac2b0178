"""The program under test as a user builds it from a configuration file:
the anchors, the builder of the configuration's backbone, the network
holding the harness's seeded raw weights."""

from __future__ import annotations

import re
from types import ModuleType
from typing import Dict

import torch

from benchmark.harness import catalog


def anchors(config: Dict):
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.config import AnchorsConfig

    a = config["anchors"]
    cfg = AnchorsConfig(
        feature_maps_shapes=tuple(tuple(s) for s in a["feature_maps_shapes"]),
        feature_maps_aspect_ratios=tuple(tuple(r) for r in a["feature_maps_aspect_ratios"]),
        boxes_scales=tuple(a["boxes_scales"]),
        centers_padding_from_borders=tuple(a["centers_padding_from_borders"]),
        additional_square_box=a["additional_square_box"])
    return Anchors.from_config(cfg, tuple(config["encoding"]["image_shape"]))


def encoding(config: Dict):
    from ssdseglib_torch.config import EncodingConfig

    e = config["encoding"]
    return EncodingConfig(num_classes=e["num_classes"], image_shape=tuple(e["image_shape"]),
                          iou_threshold=e["iou_threshold"],
                          standard_deviations=tuple(e["standard_deviations"]),
                          max_ground_truth_boxes=e["max_ground_truth_boxes"])


def backbone(name: str) -> ModuleType:
    """``harness/backbones/<name>.py``, loaded by path: its ``builder(model,
    common)`` returns the port's public builder for the backbone, given the
    configuration's ``model`` and the arguments every builder takes."""
    return catalog.load_module(catalog.BENCH_DIR / "harness" / "backbones" / f"{name}.py",
                               "bench_harness_backbone_" + re.sub(r"\W", "_", name))


def builder(config: Dict, anchor_set):
    m = config["model"]
    common = dict(
        input_image_shape=tuple(m["input_image_shape"]),
        number_of_boxes_per_point=list(m["boxes_per_point"]),
        number_of_classes=m["number_of_classes"],
        center_x_boxes_default=anchor_set.center_x, center_y_boxes_default=anchor_set.center_y,
        width_boxes_default=anchor_set.width, height_boxes_default=anchor_set.height,
        standard_deviations_centroids_offsets=tuple(config["encoding"]["standard_deviations"]))
    return backbone(m["backbone"]).builder(m, common)


def network(config: Dict, build, weights: Dict[str, torch.Tensor], device):
    """The builder's training network on ``device`` holding ``weights``."""
    net = build.get_model_for_training(
        segmentation_dilation_rates=tuple(config["model"]["segmentation_dilation_rates"]),
        generator=torch.Generator().manual_seed(0), device=device)
    net.load_state_dict(weights)
    return net


def nms_arguments(config: Dict) -> Dict:
    n = config["nms"]
    return dict(max_number_of_boxes_per_class=n["max_boxes_per_class"],
                max_number_of_boxes_per_sample=n["max_boxes_per_sample"],
                boxes_iou_threshold=n["iou_threshold"],
                labels_probability_threshold=n["score_threshold"],
                suppress_background_boxes=n["suppress_background_boxes"],
                use_segmentation_suppression=n["use_segmentation_suppression"])
