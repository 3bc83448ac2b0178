"""The top-K formulation of the port's combined NMS against the JAX package
on the same inputs: the plain version of the greedy-scan kernel against the
Pallas kernel (interpret mode) and the XLA scan, the pairwise IoU, and
``combined_nms(method="topk")`` as a whole, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.config import NmsConfig
from ssdseglib_tpu.ops import nms as tpu_nms
from ssdseglib_tpu.ops.nms_pallas import greedy_select_pallas
from ssdseglib_torch.config import NmsConfig as PortNmsConfig
from ssdseglib_torch.ops import nms as port_nms
from ssdseglib_torch.ops import nms_scan
from tests.torch_parity import random_detections


def _sorted_candidates(rng, batch=4, classes=4, k=64, spread=200.0):
    """Boxes and descending scores of K candidates per (batch, class), as
    the JAX package's kernel test draws them."""
    cx = rng.uniform(0, spread, (batch, classes, k))
    cy = rng.uniform(0, spread, (batch, classes, k))
    w = rng.uniform(5, 60, (batch, classes, k))
    h = rng.uniform(5, 60, (batch, classes, k))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, (batch, classes, k)).astype(np.float32))[..., ::-1]
    return boxes, scores.copy()


def _scan_three_ways(iou, valid, iou_thr, max_keep):
    """The plain version of the port must equal the Pallas kernel and the
    XLA scan of the JAX package exactly; returns the keep mask."""
    xla = np.asarray(tpu_nms._greedy_select(jnp.asarray(iou), jnp.asarray(valid), iou_thr,
                                            max_keep))
    pallas = np.asarray(greedy_select_pallas(jnp.asarray(iou), jnp.asarray(valid), iou_thr,
                                             max_keep, interpret=True))
    args = torch.from_numpy(iou), torch.from_numpy(valid)
    plain = nms_scan.greedy_select_reference(*args, iou_thr, max_keep).numpy()
    wrapper = nms_scan.greedy_select(*args, torch.tensor(iou_thr), max_keep).numpy()
    np.testing.assert_array_equal(pallas, xla)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(wrapper, xla)  # a CPU tensor takes the plain version
    return plain


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_thr,max_keep", [(0.4, 4), (0.025, 10), (0.9, 2)])
def test_greedy_select_matches_jax_scans(seed, iou_thr, max_keep):
    boxes, scores = _sorted_candidates(np.random.default_rng(seed))
    iou = np.array(tpu_nms._pairwise_iou_yx(jnp.asarray(boxes)))
    keep = _scan_three_ways(iou, scores > 0.3, iou_thr, max_keep)
    assert keep.sum(-1).max() <= max_keep and keep.any()


@pytest.mark.parametrize(
    "case", ["k100", "k1", "all_invalid", "all_overlap", "max_keep_beyond_k"]
)
def test_greedy_select_edge_cases(case):
    rng = np.random.default_rng(3)
    k = {"k100": 100, "k1": 1}.get(case, 32)
    boxes, scores = _sorted_candidates(rng, batch=2, classes=2, k=k)
    valid = scores > 0.2
    max_keep = 4
    if case == "all_invalid":
        valid = np.zeros_like(valid)
    if case == "all_overlap":
        boxes[...] = boxes[:, :, :1]  # one box, K times: the first suppresses the rest
        valid = np.ones_like(valid)
    if case == "max_keep_beyond_k":
        max_keep = k + 5
    iou = np.array(tpu_nms._pairwise_iou_yx(jnp.asarray(boxes)))
    keep = _scan_three_ways(iou, valid, 0.5, max_keep)
    if case == "all_invalid":
        assert not keep.any()
    if case == "all_overlap":
        assert keep[..., 0].all() and keep.sum(-1).max() == 1
    if case == "k1":
        np.testing.assert_array_equal(keep, valid)


def test_greedy_select_rejects_what_the_kernel_cannot_take():
    iou, valid = torch.zeros(2, 8, 8), torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="float32"):
        nms_scan.greedy_select(iou.double(), valid, 0.5, 4)
    with pytest.raises(ValueError, match="bool"):
        nms_scan.greedy_select(iou, valid.float(), 0.5, 4)
    with pytest.raises(ValueError, match="shape"):
        nms_scan.greedy_select(iou[:, :4], valid, 0.5, 4)
    with pytest.raises(ValueError, match="contiguous"):
        nms_scan.greedy_select(iou.transpose(1, 2), valid, 0.5, 4)
    assert nms_scan.MAX_K * ((nms_scan.MAX_K + 31) // 32 + 1) * 4 <= 232448  # 227 KB


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(4)
    boxes, _ = _sorted_candidates(rng, batch=2, classes=3, k=48, spread=80.0)
    boxes[0, 0, :8] = boxes[0, 0, :8][:, [2, 3, 0, 1]]  # swapped corners
    boxes[0, 1, :4, 2] = boxes[0, 1, :4, 0]  # zero height
    boxes[1, 2, :4] = 7.0  # zero-area points, pairwise union 0
    expected = np.asarray(tpu_nms._pairwise_iou_yx(jnp.asarray(boxes)))
    got = port_nms._pairwise_iou_yx(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)
    assert np.all(got[1, 2, :4, :4] == 0.0)  # union 0 -> IoU 0, not NaN
    assert np.all(np.isfinite(got))


def _port_nms(boxes_yx, scores, cfg_kwargs, method, tensor_thresholds=True):
    wrap = torch.tensor if tensor_thresholds else float
    return port_nms.combined_nms(
        torch.from_numpy(boxes_yx), torch.from_numpy(scores),
        PortNmsConfig(**cfg_kwargs), method=method,
        iou_threshold=wrap(cfg_kwargs["iou_threshold"]),
        score_threshold=wrap(cfg_kwargs["score_threshold"]),
    )


def _compare_nms(boxes_yx, scores, cfg_kwargs, method="topk", tensor_thresholds=True):
    """The port against the JAX package under one method (the JAX topk runs
    its XLA scan on the CPU): valid and classes exact, scores and boxes 1e-6."""
    ours = _port_nms(boxes_yx, scores, cfg_kwargs, method, tensor_thresholds)
    theirs = tpu_nms.combined_nms(boxes_yx, scores, NmsConfig(**cfg_kwargs), method=method)
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(theirs["valid"]))
    np.testing.assert_array_equal(ours["classes"].numpy(),
                                  np.asarray(theirs["classes"]))
    for key in ("scores", "boxes"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    return ours


def _cfg(iou_thr, score_thr, **extra):
    return dict(max_boxes_per_class=4, max_boxes_per_sample=10, iou_threshold=iou_thr,
                score_threshold=score_thr, **extra)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "iou_thr,score_thr", [(0.5, 0.3), (0.025, 0.725), (0.9, 0.05), (0.3, 0.6)]
)
def test_combined_nms_topk_matches_jax(seed, iou_thr, score_thr):
    boxes_yx, scores = random_detections(np.random.default_rng(seed))
    _compare_nms(boxes_yx, scores, _cfg(iou_thr, score_thr))


@pytest.mark.parametrize("tensor_thresholds", [True, False])
def test_combined_nms_topk_dense_overlaps(tensor_thresholds):
    """Dense overlaps; the thresholds as 0-d tensors (the serving path's) and
    as Python floats."""
    boxes_yx, scores = random_detections(np.random.default_rng(42), batch=2, n=256,
                                         spread=30.0)
    _compare_nms(boxes_yx, scores, _cfg(0.4, 0.4), tensor_thresholds=tensor_thresholds)


def test_combined_nms_topk_tied_scores():
    """Equal scores within a class and across classes, more of them than K:
    the candidates are the K lowest indices (a stable sort; `torch.topk`
    promises no order among ties) and the rows come in the JAX order."""
    rng = np.random.default_rng(11)
    boxes_yx, _ = random_detections(rng, batch=2, n=64, spread=400.0)
    scores = np.full((2, 64, 4), 0.5, np.float32)
    scores[:, ::5, 2] = 0.75
    scores[:, 7::9, 0] = 0.75
    out = _compare_nms(boxes_yx, scores, _cfg(0.3, 0.4, max_candidates_per_class=16))
    assert int(out["valid"].min()) == 10
    # coarsely quantised probabilities (as low-precision scores are) tie
    # everywhere: the same rows through both
    boxes_yx, scores = random_detections(rng, batch=2, n=96)
    scores = (np.round(scores * 16.0) / 16.0).astype(np.float32)
    assert len(np.unique(scores)) <= 17
    _compare_nms(boxes_yx, scores, _cfg(0.5, 0.1, max_candidates_per_class=32))


def test_combined_nms_topk_fewer_anchors_than_k():
    """K = min(max_candidates_per_class, N), and T rows come back even when
    C * K is below max_boxes_per_sample."""
    boxes_yx, scores = random_detections(np.random.default_rng(5), batch=2, n=40)
    out = _compare_nms(boxes_yx, scores, _cfg(0.5, 0.2))
    assert out["boxes"].shape == (2, 10, 4)
    boxes_yx, scores = random_detections(np.random.default_rng(6), batch=2, n=2,
                                         num_classes=3)
    out = _compare_nms(boxes_yx, scores, _cfg(0.5, 0.0))
    assert out["boxes"].shape == (2, 6, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_equals_exact_while_k_covers_the_candidates(seed):
    """At most K candidates of a class clear the score threshold (asserted):
    the two methods of the port then agree."""
    boxes_yx, scores = random_detections(np.random.default_rng(seed), batch=2, n=512,
                                         spread=300.0)
    cfg = _cfg(0.4, 0.5, max_candidates_per_class=256)
    assert (scores > cfg["score_threshold"]).sum(axis=1).max() <= 256
    topk = _port_nms(boxes_yx, scores, cfg, "topk")
    exact = _port_nms(boxes_yx, scores, cfg, "exact")
    assert int(exact["valid"].min()) > 0
    for key in exact:
        np.testing.assert_array_equal(topk[key].numpy(), exact[key].numpy(), err_msg=key)


def test_topk_truncates_beyond_k_as_jax_does():
    """One dominant box suppresses a cluster of more than K next-highest
    boxes: the exact method finds the far box, the top-K method of either
    package does not."""
    n = 600
    boxes = np.zeros((1, n, 4), np.float32)
    boxes[0, :-1] = [0.0, 0.0, 10.0, 10.0]
    boxes[0, 1:-1, :2] += np.linspace(0.01, 0.5, n - 2)[:, None]
    boxes[0, 1:-1, 2:] += np.linspace(0.01, 0.5, n - 2)[:, None]
    boxes[0, -1] = [100.0, 100.0, 110.0, 110.0]
    scores = np.zeros((1, n, 2), np.float32)
    scores[0, 0, 1] = 0.9
    scores[0, 1:-1, 1] = np.linspace(0.8, 0.5, n - 2)
    scores[0, -1, 1] = 0.3
    out = _compare_nms(boxes, scores, _cfg(0.5, 0.1))
    assert int(out["valid"][0]) == 1
    assert int(_port_nms(boxes, scores, _cfg(0.5, 0.1), "exact")["valid"][0]) == 2


def test_unknown_method_raises():
    boxes_yx, scores = random_detections(np.random.default_rng(0), batch=1, n=8)
    with pytest.raises(ValueError, match="unknown NMS method"):
        _port_nms(boxes_yx, scores, _cfg(0.5, 0.3), "top_k")
