"""Decode, segmentation suppression and the exact combined NMS of the port
against the JAX package, on the same inputs; the NMS thresholds reach the
port as 0-d tensors, as the serving path passes them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import layers as tpu_layers
from ssdseglib_tpu.boxes import Anchors
from ssdseglib_tpu.config import NmsConfig, reference_warehouse_config
from ssdseglib_tpu.ops import encoding as tpu_encoding
from ssdseglib_tpu.ops import nms as tpu_nms
from ssdseglib_torch import layers as port_layers
from ssdseglib_torch.config import NmsConfig as PortNmsConfig
from ssdseglib_torch.ops import encoding as port_encoding
from ssdseglib_torch.ops import nms as port_nms
from tests.torch_parity import random_detections

STDS = (0.1, 0.1, 0.2, 0.2)
# exp() of XLA's CPU backend and of torch differ in the last bit; near
# exp(0) = 1 one f32 ulp (1.2e-7) of (exp(o) - 1) times an anchor side of
# up to ~470 px is 5.7e-5 px, measured here as the largest difference
DECODE_ATOL = 1e-4


@pytest.fixture(scope="module")
def anchors_centroids():
    a_cfg, e_cfg = reference_warehouse_config()[:2]
    return Anchors.from_config(a_cfg, e_cfg.image_shape).centroids  # (9600, 4)


def test_decode_predictions_matches_jax(anchors_centroids):
    offsets = (np.random.default_rng(5).normal(size=(2, 9600, 4)) * 0.5).astype(
        np.float32
    )
    expected = tpu_encoding.decode_predictions_to_corners_yx(
        jnp.asarray(offsets), jnp.asarray(anchors_centroids), STDS
    )
    got = port_encoding.decode_predictions_to_corners_yx(
        torch.from_numpy(offsets), torch.from_numpy(anchors_centroids), STDS
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6,
                               atol=DECODE_ATOL)
    layer = port_layers.DecodeBoxesCentroidsOffsets(*anchors_centroids.T, *STDS)
    assert torch.equal(layer(torch.from_numpy(offsets)), got)


# A process that runs a parallel op first (the weight init that used to
# precede the decode test), then its first torch.exp over several threads.
_FIRST_EXP = """
import numpy as np, torch
import tests.torch_parity  # noqa: F401 (its import makes the first vector-math call)
g = torch.Generator().manual_seed(0)
for shape in [(960, 160), (160, 960), (576, 96), (384, 64)] * 3:
    torch.empty(shape).uniform_(-0.9, 0.9, generator=g).mul_(0.3)
x = torch.from_numpy((np.random.default_rng(5).normal(size=(2, 9600)) * 0.1).astype(np.float32))
want = np.exp(x.numpy().astype(np.float64))
print(float(np.max(np.abs(torch.exp(x).numpy() - want) / want)))
"""


@pytest.mark.parametrize("run", range(3))
def test_first_multithreaded_exp_is_exact_after_the_helpers_import(run):
    """Pins the repair of the order-dependent `test_decode_predictions_matches_jax`:
    with `tests.torch_parity.initialise_vector_math` run at import, a fresh
    process's first multi-threaded torch.exp is within one f32 ulp of the
    f64 exp on every element (without it, one thread's chunk could be off by
    1e-4 relative)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FIRST_EXP], cwd=root, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "8", "PYTHONPATH": os.pathsep.join(
                              [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)).rstrip(
                                  os.pathsep)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert float(proc.stdout.split()[-1]) < 1.2e-7


def test_decode_offsets_zero_background_matches_jax(anchors_centroids):
    offsets = np.random.default_rng(6).normal(size=(2, 9600, 4)).astype(np.float32)
    offsets[:, ::3] = 0.0  # the encoder's background rows
    expected = tpu_encoding.decode_offsets_to_centroids(
        jnp.asarray(offsets), jnp.asarray(anchors_centroids), STDS
    )
    got = port_encoding.decode_offsets_to_centroids(
        torch.from_numpy(offsets), torch.from_numpy(anchors_centroids), STDS
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6,
                               atol=DECODE_ATOL)
    assert np.all(got.numpy()[:, ::3] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmentation_suppression_matches_jax(dtype):
    """Batch-global presence, depth 4; in bf16 the mask has many argmax
    ties, which go to the first index in both packages."""
    rng = np.random.default_rng(3)
    mask = rng.dirichlet(np.ones(4), size=(2, 8, 12)).astype(np.float32)
    mask[..., 3] = 0.0  # class 3 never the argmax anywhere in the batch
    mask[0, :4, :4] = [0.4, 0.4, 0.2, 0.0]  # exact ties between 0 and 1
    mask[1, :4, :4] = [0.25, 0.375, 0.375, 0.0]  # ties between 1 and 2
    probs = rng.uniform(size=(2, 16, 4)).astype(np.float32)
    jmask = jnp.asarray(mask, jnp.dtype(dtype))
    tmask = torch.from_numpy(mask).to(getattr(torch, dtype))
    expected = tpu_layers.SegmentationSuppression()(jmask, jnp.asarray(probs))
    got = port_layers.SegmentationSuppression()(tmask, torch.from_numpy(probs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    assert np.all(got.numpy()[..., 3] == 0.0)
    np.testing.assert_array_equal(
        tmask.argmax(-1).numpy(), np.asarray(jnp.argmax(jmask, axis=-1))
    )


def _compare_nms(boxes_yx, scores, cfg_kwargs):
    ours = port_nms.combined_nms(
        torch.from_numpy(boxes_yx), torch.from_numpy(scores),
        PortNmsConfig(**cfg_kwargs),
        iou_threshold=torch.tensor(cfg_kwargs["iou_threshold"]),
        score_threshold=torch.tensor(cfg_kwargs["score_threshold"]),
    )
    theirs = tpu_nms.combined_nms(boxes_yx, scores, NmsConfig(**cfg_kwargs),
                                  method="exact")
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(theirs["valid"]))
    np.testing.assert_array_equal(ours["classes"].numpy(),
                                  np.asarray(theirs["classes"]))
    for key in ("scores", "boxes"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    return ours


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "iou_thr,score_thr", [(0.5, 0.3), (0.025, 0.725), (0.9, 0.05), (0.3, 0.6)]
)
def test_combined_nms_matches_jax(seed, iou_thr, score_thr):
    boxes_yx, scores = random_detections(np.random.default_rng(seed))
    _compare_nms(boxes_yx, scores, dict(max_boxes_per_class=4, max_boxes_per_sample=10,
                                        iou_threshold=iou_thr,
                                        score_threshold=score_thr))


def test_combined_nms_dense_overlaps():
    boxes_yx, scores = random_detections(np.random.default_rng(42), batch=2, n=256,
                                         spread=30.0)
    _compare_nms(boxes_yx, scores, dict(max_boxes_per_class=4, max_boxes_per_sample=10,
                                        iou_threshold=0.4, score_threshold=0.4))


def test_combined_nms_production_scale():
    """9600 anchors with thousands of candidates per class above the
    score threshold."""
    boxes_yx, scores = random_detections(np.random.default_rng(7), batch=2, n=9600,
                                         spread=600.0)
    assert (scores > 0.05).sum(axis=1).min() > 256
    out = _compare_nms(boxes_yx, scores, dict(max_boxes_per_class=4,
                                              max_boxes_per_sample=10,
                                              iou_threshold=0.6,
                                              score_threshold=0.05))
    assert out["valid"].min() == 10


def test_combined_nms_beyond_topk_window():
    """One dominant box suppresses a huge cluster of next-highest boxes;
    the true second pick is the lowest-scoring candidate."""
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
    out = _compare_nms(boxes, scores, dict(max_boxes_per_class=4,
                                           max_boxes_per_sample=10,
                                           iou_threshold=0.5, score_threshold=0.1))
    assert int(out["valid"][0]) == 2
    assert float(out["scores"][0, 1]) == pytest.approx(0.3)


def test_combined_nms_tied_scores():
    """Equal scores within a class (argmax: first index) and across
    classes (stable class-major sort): the row order is the JAX order."""
    rng = np.random.default_rng(11)
    boxes_yx, _ = random_detections(rng, batch=2, n=64, spread=400.0)
    scores = np.full((2, 64, 4), 0.5, np.float32)
    scores[:, ::5, 2] = 0.75
    scores[:, 7::9, 0] = 0.75
    out = _compare_nms(boxes_yx, scores, dict(max_boxes_per_class=4,
                                              max_boxes_per_sample=10,
                                              iou_threshold=0.3, score_threshold=0.4))
    assert int(out["valid"].min()) == 10


def test_nms_layer_matches_jax_layer():
    boxes_yx, scores = random_detections(np.random.default_rng(0), batch=2)
    args = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
                boxes_iou_threshold=0.5, labels_probability_threshold=0.3)
    expected = tpu_layers.NonMaximumSuppression(**args)(boxes_yx, scores)
    got = port_layers.NonMaximumSuppression(**args)(
        torch.from_numpy(boxes_yx), torch.from_numpy(scores)
    )
    assert got.shape == (2, 10, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)
