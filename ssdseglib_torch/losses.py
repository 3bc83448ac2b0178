"""Training losses (PyTorch), counterparts of ssdseglib_tpu/losses.py
(reference ssdseglib/losses.py).

All functions keep the reference's per-sample reduction contract: given
``y_true``/``y_pred`` of a batch they return one scalar loss per batch item,
shape ``(batch,)``; the train step averages over the batch and applies the
per-output loss weights (the Keras `compile(loss_weights=...)` contract).

Reference quirks preserved on purpose:
- hard-negative mining selects top-k background losses **globally over the
  flattened batch**, not per sample; inside a `parallel.mesh.data_parallel`
  scope the batch is the global batch of all ranks
- the confidence/cross-entropy losses consume *probabilities* (the model
  emits softmax), re-log-ed with an epsilon clip -- not logits
- localization loss normalizes by per-sample positive count

On a mesh that splits the rows (`parallel.spatial`) the mask losses' per-sample
sums over H and W are summed over the spatial ranks (`sum_over_rows`); the
detection losses see the heads' outputs whole on every spatial rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ssdseglib_torch.parallel.mesh import active_group, gather_by_sum
from ssdseglib_torch.parallel.spatial import sum_over_rows

_EPSILON = 1e-7  # tf.keras.backend.epsilon()


def localization_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 over the 4 offsets of positive (non-background) anchors.
    Background anchors are identified by their all-zero encoded offsets.

    Args:
        y_true: (B, N, 4) encoded ground-truth offsets
        y_pred: (B, N, 4) predicted offsets
    Returns:
        (B,) per-sample loss.
    """
    not_background = (y_true.abs().sum(dim=-1) > 0.0).to(y_pred.dtype)

    abs_err = (y_true - y_pred).abs()
    sq_err = torch.square(y_true - y_pred)
    smooth_l1 = torch.where(abs_err < 1.0, sq_err * 0.5, abs_err - 0.5)
    per_box = smooth_l1.sum(dim=-1) * not_background

    num_pos = not_background.sum(dim=-1)
    return per_box.sum(dim=-1) / num_pos.clamp_min(1.0)


def confidence_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    negatives_ratio: Optional[float] = 3.0,
) -> torch.Tensor:
    """Softmax CE with batch-global hard-negative mining.

    The top-k selection over background losses runs on the flattened (B*N,)
    tensor with ``k = min(int(ratio * total_positives), total_negatives)`` --
    a *global* budget.  All background losses are ranked once (stable
    descending sort, ties to the lower flat index) and entries with
    rank < k are kept: static shapes, no host synchronisation on k, and the
    no-background corner collapses to k == 0 with no branch.

    Inside a `parallel.mesh.data_parallel` scope ``y_true`` / ``y_pred``
    are this rank's slice of the global batch, and the mining is the
    single-process mining of the global batch: the budget counts every
    rank's positives and backgrounds, and each background loss is ranked
    among all ranks' (ties to the lower GLOBAL flat index; rank r's entries
    start at r * B * N).  One collective gathers the ranks' background
    losses and counts.  The normalisation by each sample's positives stays
    local.

    Args:
        y_true: (B, N, C) one-hot labels (class 0 = background)
        y_pred: (B, N, C) predicted probabilities
        negatives_ratio: hard-negative budget as a multiple of the positive
            count (3.0 is the reference's behaviour).  ``None``: every
            background anchor contributes (plain CE normalized by positives).
    Returns:
        (B,) per-sample loss.
    """
    is_background = y_true[:, :, 0]
    not_background = (is_background - 1.0).abs()

    log_pred = torch.log(y_pred.clamp(_EPSILON, 1.0 - _EPSILON))
    ce = -(y_true * log_pred).sum(dim=-1)  # (B, N)

    pos_loss = (ce * not_background).sum(dim=-1)  # (B,)
    num_pos_per_sample = not_background.sum(dim=-1)

    if negatives_ratio is None:
        neg_loss = (ce * is_background).sum(dim=-1)
        return (pos_loss + neg_loss) / num_pos_per_sample.clamp_min(1.0)

    bg_loss_flat = (ce * is_background).detach().reshape(-1)
    group = active_group()
    if group is None:
        total_pos = not_background.sum().to(torch.int32)
        total_bg = is_background.sum().to(torch.int32)
        ranked = bg_loss_flat
    else:
        # the ranks' background losses in global order, and the two counts
        # summed over the ranks (exact: integers below 2^24 in f32)
        counts = torch.stack([not_background.sum(), is_background.sum()])
        local = torch.cat([bg_loss_flat, counts.to(bg_loss_flat.dtype)])
        gathered = gather_by_sum(local.reshape(1, -1), group)
        total_pos, total_bg = gathered[:, -2:].sum(dim=0).to(torch.int32)
        ranked = gathered[:, :-2].reshape(-1)
    # global hard-negative budget; the product is taken in f32 and truncated,
    # as the JAX package's int32 cast does
    k = torch.minimum(
        (negatives_ratio * total_pos.to(torch.float32)).to(torch.int32), total_bg
    )

    order = torch.sort(-ranked, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    if group is not None:  # this rank's entries of the global ranking
        start = torch.distributed.get_rank(group) * bg_loss_flat.shape[0]
        rank = rank[start:start + bg_loss_flat.shape[0]]
    keep = (rank < k).to(ce.dtype).reshape(ce.shape)

    neg_loss = (ce * is_background * keep).sum(dim=-1)  # (B,)
    return (pos_loss + neg_loss) / num_pos_per_sample.clamp_min(1.0)


def _cached_weights(classes_weights: Sequence[float]) -> Callable:
    """``like -> (C,) f32 weights on like's device``, built once per device so
    a step makes no host-to-device copy."""
    cache = {}

    def weights(like: torch.Tensor) -> torch.Tensor:
        if like.device not in cache:
            cache[like.device] = torch.tensor(
                list(classes_weights), dtype=torch.float32, device=like.device
            )
        return cache[like.device]

    return weights


def dice(classes_weights: Sequence[float]) -> Callable:
    """Weighted Dice loss factory."""
    _weights = _cached_weights(classes_weights)

    def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        sums = sum_over_rows(torch.stack([(y_true * y_pred).sum(dim=(1, 2)),
                                          (y_true + y_pred).sum(dim=(1, 2))]))
        loss = 1.0 - (2.0 * sums[0] + _EPSILON) / (sums[1] + _EPSILON)
        return (loss * _weights(y_pred)).sum(dim=-1)

    return dice_loss


def dice_square(classes_weights: Sequence[float]) -> Callable:
    """Weighted squared-denominator Dice loss factory."""
    _weights = _cached_weights(classes_weights)

    def dice_square_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        sums = sum_over_rows(torch.stack([
            (y_true * y_pred).sum(dim=(1, 2)),
            (torch.square(y_true) + torch.square(y_pred)).sum(dim=(1, 2))]))
        loss = 1.0 - (2.0 * sums[0] + _EPSILON) / (sums[1] + _EPSILON)
        return (loss * _weights(y_pred)).sum(dim=-1)

    return dice_square_loss


def cross_entropy(classes_weights: Sequence[float]) -> Callable:
    """Weighted CE-over-probabilities factory.

    The reference sums CE over the full (H, W) plane per class (no
    pixel-count normalization) before the weighted class sum -- preserved.
    """
    _weights = _cached_weights(classes_weights)

    def cross_entropy_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        log_pred = torch.log(y_pred.clamp(_EPSILON, 1.0 - _EPSILON))
        loss = -sum_over_rows((y_true * log_pred).sum(dim=(1, 2)))  # (B, C)
        return (loss * _weights(y_pred)).sum(dim=-1)

    return cross_entropy_loss
