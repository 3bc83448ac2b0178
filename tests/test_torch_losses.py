"""The port's losses against ssdseglib_tpu.losses on the same NumPy inputs.
Each returns (B,) per-sample values; tolerance rtol 1e-5 / atol 1e-6 (f32 on
the CPU in both, sums of up to a few thousand terms in another order), and
the hard-negative selection itself must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import losses as tpu_losses
from ssdseglib_torch import losses

TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHTS = (0.05, 0.575, 0.135, 0.24)


def _detection_batch(seed, batch=3, boxes=200, classes=4, positive_share=0.05):
    rng = np.random.default_rng(seed)
    labels = np.where(rng.uniform(size=(batch, boxes)) < positive_share,
                      rng.integers(1, classes, (batch, boxes)), 0)
    y_true = np.eye(classes, dtype=np.float32)[labels]
    logits = rng.normal(size=(batch, boxes, classes)).astype(np.float32) * 2.0
    y_pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return y_true, y_pred.astype(np.float32)


def _both(fn_port, fn_tpu, *arrays, **kwargs):
    got = fn_port(*(torch.tensor(a) for a in arrays), **kwargs)
    want = fn_tpu(*(jnp.asarray(a) for a in arrays), **kwargs)
    assert got.dtype == torch.float32 and got.shape == (arrays[0].shape[0],)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_localization_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    y_true = rng.normal(size=(3, 50, 4)).astype(np.float32) * 2.0
    y_true[rng.uniform(size=(3, 50)) < 0.7] = 0.0  # background rows
    y_true[2] = 0.0  # a sample without positives: divides by max(0, 1)
    y_pred = rng.normal(size=(3, 50, 4)).astype(np.float32) * 2.0
    got, want = _both(losses.localization_loss, tpu_losses.localization_loss, y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
    assert got[2] == 0.0


@pytest.mark.parametrize("ratio", [3.0, 1.5, None])
def test_confidence_loss_matches_jax(ratio):
    y_true, y_pred = _detection_batch(2)
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred,
                      negatives_ratio=ratio)
    np.testing.assert_allclose(got, want, **TOL)


def test_confidence_loss_budget_truncates_like_jax():
    """k = int32(ratio * positives): 7 positives at ratio 1.5 give k = 10,
    not 11 (the product 10.5 is truncated)."""
    y_true, y_pred = _detection_batch(3, batch=1, boxes=60, positive_share=0.0)
    y_true[0, :7] = np.eye(4, dtype=np.float32)[1]
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred,
                      negatives_ratio=1.5)
    np.testing.assert_allclose(got, want, **TOL)
    ce = -np.sum(y_true * np.log(y_pred), -1)[0]
    by_hand = (ce[:7].sum() + np.sort(ce[7:])[::-1][:10].sum()) / 7.0
    np.testing.assert_allclose(got[0], by_hand, rtol=1e-5)


def test_confidence_loss_ties_go_to_the_lower_flat_index():
    """Equal background losses at the budget's edge: the stable descending
    sort keeps the anchors with the lower flat index, across samples."""
    classes = 4
    y_true = np.zeros((2, 6, classes), np.float32)
    y_true[..., 0] = 1.0
    y_true[0, 0] = np.eye(classes)[2]  # one positive: k = 3 of 11 backgrounds
    y_pred = np.full((2, 6, classes), 0.25, np.float32)  # every loss equal
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
    ce = -np.log(0.25)
    # the 3 kept negatives are flat indices 1, 2, 3: all in sample 0
    np.testing.assert_allclose(got, [4 * ce, 0.0], rtol=1e-6)
    # gradient reaches exactly the kept anchors
    pred = torch.tensor(y_pred, requires_grad=True)
    losses.confidence_loss(torch.tensor(y_true), pred).sum().backward()
    touched = (pred.grad.abs().sum(-1) > 0).numpy()
    assert touched.tolist() == [[True] * 4 + [False] * 2, [False] * 6]


def test_confidence_loss_k_zero_and_no_background_corners():
    classes = 4
    # no positives anywhere: k == 0, every sample's loss is 0
    y_true = np.zeros((2, 5, classes), np.float32)
    y_true[..., 0] = 1.0
    _, y_pred = _detection_batch(4, batch=2, boxes=5)
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got == 0.0).all()
    # no background at all: k = min(3 * positives, 0) = 0
    y_true = np.zeros((2, 5, classes), np.float32)
    y_true[..., 1] = 1.0
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all() and (got > 0).all()


def test_losses_clip_probabilities_at_epsilon():
    y_true = np.zeros((1, 3, 4), np.float32)
    y_true[0, :, 1] = 1.0
    y_pred = np.zeros((1, 3, 4), np.float32)
    y_pred[0, :, 0] = 1.0  # the true class has probability exactly 0
    got, want = _both(losses.confidence_loss, tpu_losses.confidence_loss, y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, [-np.log(1e-7)], rtol=1e-5)


@pytest.mark.parametrize("name", ["dice", "dice_square", "cross_entropy"])
def test_mask_losses_match_jax(name):
    rng = np.random.default_rng(5)
    classes = len(WEIGHTS)
    y_true = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, (2, 12, 16))]
    logits = rng.normal(size=(2, 12, 16, classes)).astype(np.float32) * 3.0
    y_pred = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    y_pred[0, 0, 0] = (1.0, 0.0, 0.0, 0.0)  # a saturated pixel: the clip matters
    got, want = _both(getattr(losses, name)(list(WEIGHTS)),
                      getattr(tpu_losses, name)(list(WEIGHTS)), y_true, y_pred)
    np.testing.assert_allclose(got, want, **TOL)
