"""The port's ground-truth encoder against ssdseglib_tpu.ops.encoding on the
same NumPy ground truth: labels equal exactly; offsets rtol 1e-6 / atol 1e-6
(XLA and torch round `log` differently in the last bit, and the offsets are
divided by standard deviations of 0.1-0.2).  Also the copy of the synthetic
data generator, which must be equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.boxes import Anchors as TpuAnchors
from ssdseglib_tpu.config import reference_warehouse_config as tpu_config
from ssdseglib_tpu.data import synthetic as tpu_synthetic
from ssdseglib_tpu.ops import encoding as tpu_encoding
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import reference_warehouse_config
from ssdseglib_torch.data import synthetic
from ssdseglib_torch.ops import encoding


def _padded(samples, budget):
    n = len(samples)
    labels = np.zeros((n, budget), np.int32)
    boxes = np.zeros((n, budget, 4), np.float32)
    valid = np.zeros((n, budget), bool)
    for i, s in enumerate(samples):
        g = min(len(s.labels), budget)
        labels[i, :g], boxes[i, :g], valid[i, :g] = s.labels[:g], s.boxes[:g], True
    return labels, boxes, valid


def _assert_encoded_equal(got, want):
    labels, offsets = got
    want_labels, want_offsets = (np.asarray(a) for a in want)
    assert labels.dtype == offsets.dtype == torch.float32
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_allclose(offsets.numpy(), want_offsets, rtol=1e-6, atol=1e-6)


def test_make_batch_encoder_matches_jax_on_synthetic_scenes():
    """Six 480x640 scenes with 1-6 objects in a 32-slot budget (so most
    slots are padding) over the 9600 warehouse anchors."""
    a_cfg, e_cfg = reference_warehouse_config()[:2]
    ta_cfg, te_cfg = tpu_config()[:2]
    gt = _padded(synthetic.generate_dataset(6, seed=7), e_cfg.max_ground_truth_boxes)
    assert not gt[2].all() and gt[2].any()
    got = encoding.make_batch_encoder(
        Anchors.from_config(a_cfg, e_cfg.image_shape), e_cfg, device="cpu")(*gt)
    want = tpu_encoding.make_batch_encoder(
        TpuAnchors.from_config(ta_cfg, te_cfg.image_shape), te_cfg)(*gt)
    _assert_encoded_equal(got, want)
    labels = got[0]
    assert tuple(labels.shape) == (6, 9600, 4) and (labels[..., 1:].sum() > 0)
    # background rows carry zero offsets, matched rows do not
    matched = labels[..., 0] == 0
    assert (got[1][~matched] == 0).all() and (got[1][matched].abs().sum(-1) > 0).all()


SMALL_ANCHORS = np.array(
    [[0, 0, 9, 9], [10, 0, 19, 9], [0, 10, 9, 19], [10, 10, 19, 19], [5, 5, 14, 14]],
    np.float32)


def _encode_both(labels, boxes, valid, threshold=0.5):
    kwargs = dict(num_classes=4, iou_threshold=threshold,
                  standard_deviations=(0.1, 0.1, 0.2, 0.2))
    got = encoding.encode_sample(
        torch.tensor(labels, dtype=torch.int64), torch.tensor(boxes),
        torch.tensor(valid), torch.tensor(SMALL_ANCHORS), **kwargs)
    want = tpu_encoding.encode_sample(
        jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(SMALL_ANCHORS), **kwargs)
    _assert_encoded_equal(got, want)
    return got[0].argmax(-1).tolist()


def test_collision_of_gt_side_claims_goes_to_the_highest_gt_index():
    """Two ground truths (classes 1 and 2) whose best anchor is the same
    anchor 4, both below the anchor-side threshold: the later one wins."""
    boxes = np.array([[4, 4, 12, 12], [6, 6, 15, 15], [0, 0, 0, 0]], np.float32)
    classes = _encode_both(np.array([1, 2, 0]), boxes, np.array([True, True, False]),
                           threshold=0.9)
    assert classes == [0, 0, 0, 0, 2]


def test_anchor_side_threshold_is_strict_and_padded_slots_are_ignored():
    """A ground truth equal to anchor 0 shifted by 3 px has IoU with it of
    exactly 70 / 130; at that threshold the anchor-side claim is refused
    (strict >), just below it is taken.  The padded slot's box covers anchor
    3 exactly and must claim nothing."""
    boxes = np.array([[3, 0, 12, 9], [10, 10, 19, 19]], np.float32)
    labels, valid = np.array([3, 2]), np.array([True, False])
    iou = float(encoding.iou_matrix(torch.tensor(SMALL_ANCHORS), torch.tensor(boxes))[0, 0])
    assert iou == np.float32(70.0) / np.float32(130.0)
    want_iou = np.asarray(tpu_encoding.iou_matrix(jnp.asarray(SMALL_ANCHORS),
                                                  jnp.asarray(boxes)))
    np.testing.assert_array_equal(
        encoding.iou_matrix(torch.tensor(SMALL_ANCHORS), torch.tensor(boxes)).numpy(), want_iou)
    # the gt-side claim (step 1) gives it anchor 0 either way; anchor 1
    # (IoU 30/170) only through the anchor side
    at = _encode_both(labels, boxes, valid, threshold=iou)
    below = _encode_both(labels, boxes, valid, threshold=30.0 / 170.0 - 1e-3)
    assert at == [3, 0, 0, 0, 0]
    assert below[0] == 3 and below[1] == 3 and below[3] == 0


def test_match_anchors_matches_jax_on_random_iou_with_ties():
    rng = np.random.default_rng(3)
    iou = np.round(rng.uniform(size=(4, 40, 6)), 1).astype(np.float32)  # many ties
    valid = rng.uniform(size=(4, 6)) < 0.7
    got = encoding.match_anchors(torch.tensor(iou), torch.tensor(valid), 0.5)
    for b in range(4):
        want = tpu_encoding.match_anchors(jnp.asarray(iou[b]), jnp.asarray(valid[b]), 0.5)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs", [dict(), dict(non_overlapping=True),
                                    dict(image_shape=(96, 128), num_classes=3)])
def test_synthetic_copy_equals_jax_package(kwargs):
    ours = synthetic.generate_dataset(3, seed=5, **kwargs)
    theirs = tpu_synthetic.generate_dataset(3, seed=5, **kwargs)
    for a, b in zip(ours, theirs):
        for field in ("image", "mask", "labels", "boxes"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=field)
