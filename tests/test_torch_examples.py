"""The port's example drivers (ssdseglib_torch/examples: the counterparts of
examples/01, 04 and 99) against the calls the JAX package's drivers make,
on the CPU at reduced sizes."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import evaluators as jax_evaluators
from ssdseglib_tpu.boxes import DefaultBoundingBoxes
from ssdseglib_tpu.data.pipeline import _load_sample
from ssdseglib_tpu.data.synthetic import generate_dataset, generate_sample
from ssdseglib_tpu.datacoder import DataEncoderDecoder
from ssdseglib_tpu.layers import NonMaximumSuppression
from ssdseglib_torch.examples import (
    check_dataset_class_imbalance,
    detection_learning,
    ssd_framework,
)
from tests.torch_parity import two_torch_threads  # noqa: F401


def test_ssd_framework_is_the_jax_walkthrough():
    """examples/01's calls on the JAX package: the anchor count and grids,
    the positives of the scene and of its flip, the decode round trip."""
    result = ssd_framework.run(device="cpu", log_fn=lambda line: None)
    boxes_default = DefaultBoundingBoxes(**ssd_framework.ANCHORS)
    boxes_default.rescale_boxes_coordinates(image_shape=ssd_framework.IMAGE_SHAPE)
    per_map = boxes_default.get_boxes_coordinates_corners("feature-maps")
    assert result["anchors"] == 9600
    assert result["boxes_per_map"] == [list(m.shape[:3]) for m in per_map]
    coder = DataEncoderDecoder(
        image_shape=ssd_framework.IMAGE_SHAPE,
        xmin_boxes_default=boxes_default.get_boxes_coordinates_xmin("ssd"),
        ymin_boxes_default=boxes_default.get_boxes_coordinates_ymin("ssd"),
        xmax_boxes_default=boxes_default.get_boxes_coordinates_xmax("ssd"),
        ymax_boxes_default=boxes_default.get_boxes_coordinates_ymax("ssd"),
        **ssd_framework.ENCODING)
    sample = generate_sample(0, image_shape=ssd_framework.IMAGE_SHAPE)
    assert result["labels"] == sample.labels.tolist()
    labels, offsets = coder.encode_ground_truth(sample.labels, sample.boxes)
    matched = np.asarray(labels)[:, 0] == 0
    assert result["positives"] == int(matched.sum()) > 0
    decoded = np.asarray(coder.decode_to_corners(offsets))[matched]
    worst = max(float(np.min(np.max(np.abs(sample.boxes - d), axis=1))) for d in decoded)
    assert abs(result["decode_worst_corner_error_px"] - worst) <= 1e-4
    flipped, _ = coder.encode_ground_truth(sample.labels, sample.boxes, flip_horizontal=True)
    assert result["positives_after_flip"] == int((np.asarray(flipped)[:, 0] == 0).sum())


def test_class_imbalance_is_the_jax_loader_s():
    """examples/99's numbers over 8 synthetic scenes, computed here through
    the JAX package's loader as that driver computes them."""
    result = check_dataset_class_imbalance.run(samples=8, log_fn=lambda line: None)
    box_counts, pixels = Counter(), np.zeros(4, np.int64)
    ratios = {c: [] for c in range(1, 4)}
    for sample in generate_dataset(8, image_shape=(480, 640)):
        _, mask, labels, boxes, valid = _load_sample(sample, max_gt=64)
        classes, counts = np.unique(mask, return_counts=True)
        for c, n in zip(classes, counts):
            if c < 4:
                pixels[c] += int(n)
        for label, box in zip(labels[valid], boxes[valid]):
            box_counts[int(label)] += 1
            ratios[int(label)].append((box[2] - box[0] + 1.0) / (box[3] - box[1] + 1.0))
    assert result["samples"] == 8
    assert result["box_counts"] == dict(sorted(box_counts.items()))
    assert result["pixel_counts"] == pixels.tolist()
    np.testing.assert_allclose(result["pixel_shares"], pixels / pixels.sum(), rtol=1e-12)
    inverse = 1.0 / pixels
    np.testing.assert_allclose(result["inverse_frequency_weights"], inverse / inverse.sum(),
                               rtol=1e-12)
    assert set(result["aspect_ratio_percentiles"]) == {c for c, r in ratios.items() if r}
    for c, p in result["aspect_ratio_percentiles"].items():
        np.testing.assert_allclose(p, np.percentile(ratios[c], [5, 25, 50, 75, 95]),
                                   rtol=1e-12)


def _raw_outputs(seed: int = 5, batch: int = 4, anchors: int = 9600):
    """Seeded raw outputs of a detector on ``batch`` scenes of three objects
    each: (S, N, 4) yx corners (each object's box jittered at 40 anchors,
    the rest scattered) and (S, N, 4) class probabilities (the jittered
    anchors confident in the object's class, the rest mostly background),
    and the (labels, xyxy boxes)
    ground truth of each scene."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, anchors, 4), np.float32)
    scores = rng.dirichlet([4.0, 0.3, 0.3, 0.3], (batch, anchors)).astype(np.float32)
    gt = []
    for s in range(batch):
        corner = rng.uniform(0, 400, (anchors, 2))
        boxes[s] = np.concatenate([corner, corner + rng.uniform(10, 120, (anchors, 2))], 1)
        labels, truth = np.array([1, 2, 3], np.int32), []
        for i, label in enumerate(labels):
            ymin, xmin = rng.uniform(0, 350), rng.uniform(0, 520)
            h, w = rng.uniform(40, 120), rng.uniform(40, 120)
            truth.append([xmin, ymin, xmin + w, ymin + h])
            rows = slice(40 * i, 40 * (i + 1))
            jitter = rng.normal(0, 6, (40, 4))
            boxes[s, rows] = np.array([ymin, xmin, ymin + h, xmin + w]) + jitter
            p = rng.uniform(0.2, 0.95, 40)
            scores[s, rows] = ((1 - p) / 3)[:, None]
            scores[s, rows, label] = p
        gt.append((labels, np.array(truth, np.float32)))
    return boxes, scores, gt


GRID = dict(iou_grid=(0.025, 0.2, 0.5), prob_grid=(0.3, 0.5, 0.7))


def test_nms_grid_search_is_the_jax_loop():
    """`nms_grid_search` against examples/04's loop over the JAX package's
    NonMaximumSuppression and evaluator, on the same raw outputs: every
    point's mAP@0.5 (1e-6) and the best point."""
    boxes, scores, gt = _raw_outputs()
    got = detection_learning.nms_grid_search(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             gt, 4, 10, **GRID)
    want, best = [], None
    for iou_thr in GRID["iou_grid"]:
        for prob_thr in GRID["prob_grid"]:
            nms = NonMaximumSuppression(
                max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
                boxes_iou_threshold=iou_thr, labels_probability_threshold=prob_thr,
                suppress_background_boxes=False)
            det = np.asarray(nms(jnp.asarray(boxes), jnp.asarray(scores)))
            ap = jax_evaluators.average_precision_object_detection(
                det[:, :, 0].astype(np.int32), det[:, :, 1], det[:, :, 2:], 0.5, gt,
                labels_codes=[0, 1, 2, 3], label_code_background=0)
            m = float(np.mean(list(ap.values())))
            want.append(m)
            if best is None or m > best[0]:
                best = (m, iou_thr, prob_thr, det)
    assert [p["iou"] for p in got["points"]] == [i for i in GRID["iou_grid"]
                                                for _ in GRID["prob_grid"]]
    np.testing.assert_allclose([p["mAP@0.5"] for p in got["points"]], want, rtol=1e-6,
                               atol=1e-6)
    assert best[0] > 0.0 and len(set(want)) > 1  # the grid discriminates
    assert (got["best"]["iou"], got["best"]["prob"]) == best[1:3]
    np.testing.assert_allclose(got["detections"], best[3], rtol=1e-5, atol=1e-4)


def test_detection_learning_end_to_end_on_the_cpu(tmp_path):
    """2 steps at b2 on 2 + 2 scenes at 96x128 with the defaults' bf16,
    PreciseBN, an evaluation, checkpoints and the JSONL log, then the grid
    search; a resumed run takes one more step from the checkpoint."""
    options = dict(batch_size=2, train_scenes=2, eval_scenes=2, warmup_steps=1,
                   eval_every=2, log_every=1, precise_bn=1, image_shape=(96, 128),
                   checkpoint_dir=str(tmp_path / "ckpt"), log_file=str(tmp_path / "log.jsonl"),
                   device="cpu", log_fn=lambda line: None)
    result = detection_learning.run(steps=2, **options)
    assert result["steps_run"] == 2 and result["compute_dtype"] == "bfloat16"
    assert [r["step"] for r in result["logged"]] == [1, 2]
    assert np.isfinite([r["loss"] for r in result["logged"]]).all()
    assert [e["step"] for e in result["evals"]] == [2]
    assert len(result["grid"]) == 30 and result["best"] in result["grid"]
    for metrics in (result["evals"][0], result["final"]):
        assert all(metrics[k] >= 0.0 for k in ("mAP@0.5", "mAP@0.6", "mAP@0.7", "mIoU"))
    resumed = detection_learning.run(steps=3, resume=True, **options)
    assert resumed["start_step"] == 2 and resumed["steps_run"] == 1
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert any('"final/mAP@0.5"' in line for line in lines)


@pytest.mark.parametrize("module", [ssd_framework, detection_learning])
def test_drivers_need_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        module.main([])
