"""The port's streaming metrics against ssdseglib_tpu.metrics on the same
NumPy inputs: (B,) per-sample values, rtol 1e-5 / atol 1e-6 (f32 on the CPU
in both; exp and sums differ in the last bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import metrics as tpu_metrics
from ssdseglib_tpu.boxes import Anchors as TpuAnchors
from ssdseglib_tpu.config import reference_warehouse_config as tpu_config
from ssdseglib_torch import metrics
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import reference_warehouse_config

TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHTS = (0.05, 0.575, 0.135, 0.24)
STDS = (0.1, 0.1, 0.2, 0.2)


def test_soft_mask_iou_matches_jax():
    rng = np.random.default_rng(0)
    y_true = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 12, 16))]
    logits = rng.normal(size=(3, 12, 16, 4)).astype(np.float32)
    y_pred = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    got = metrics.jaccard_iou_segmentation_masks(list(WEIGHTS))(
        torch.tensor(y_true), torch.tensor(y_pred))
    want = tpu_metrics.jaccard_iou_segmentation_masks(list(WEIGHTS))(
        jnp.asarray(y_true), jnp.asarray(y_pred))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def anchors():
    a_cfg, e_cfg = reference_warehouse_config()[:2]
    ta_cfg, te_cfg = tpu_config()[:2]
    return (Anchors.from_config(a_cfg, e_cfg.image_shape),
            TpuAnchors.from_config(ta_cfg, te_cfg.image_shape))


def test_box_iou_matches_jax_and_is_nan_without_positives(anchors):
    """Decoded-box IoU over the 9600 warehouse anchors.  Sample 2 has no
    positive anchor: the JAX metric divides 0 by 0 there and gives NaN, and
    so does the port (no clamp on the positive count)."""
    ours, theirs = anchors
    rng = np.random.default_rng(1)
    n = ours.total_boxes
    y_true = rng.normal(size=(3, n, 4)).astype(np.float32)
    y_true[rng.uniform(size=(3, n)) < 0.9] = 0.0
    y_true[2] = 0.0
    y_pred = (y_true + rng.normal(size=(3, n, 4)) * 0.5).astype(np.float32)
    y_pred[0, :50, 2:] = -30.0  # collapsed boxes: the max(0, size) clamp
    got = metrics.jaccard_iou_bounding_boxes(ours, STDS)(
        torch.tensor(y_true), torch.tensor(y_pred)).numpy()
    want = np.asarray(tpu_metrics.jaccard_iou_bounding_boxes(theirs, STDS)(
        jnp.asarray(y_true), jnp.asarray(y_pred)))
    assert np.isnan(want[2]) and np.isnan(got[2])
    np.testing.assert_allclose(got[:2], want[:2], **TOL)
    assert (got[:2] > 0).all()


def test_categorical_accuracy_matches_jax_with_ties_to_the_first_index():
    rng = np.random.default_rng(2)
    classes = 4
    y_true = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, (2, 40))]
    y_pred = rng.uniform(size=(2, 40, classes)).astype(np.float32)
    y_pred[0, :10] = 0.25  # four-way ties: argmax takes class 0
    y_pred[1, :10, 1:3] = 0.9  # two-way ties: argmax takes class 1
    weights = [0.0, 1 / 3, 1 / 3, 1 / 3]
    got = metrics.categorical_accuracy(weights)(torch.tensor(y_true), torch.tensor(y_pred))
    want = tpu_metrics.categorical_accuracy(weights)(jnp.asarray(y_true), jnp.asarray(y_pred))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tied = torch.full((1, 1, classes), 0.25)
    first = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]])
    assert float(metrics.categorical_accuracy([1.0, 0, 0, 0])(first, tied)) == 1.0
