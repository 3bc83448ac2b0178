"""The port's NumPy evaluators (ssdseglib_torch/evaluators.py) against
ssdseglib_tpu/evaluators.py on the inputs of tests/test_evaluators.py: the
same arithmetic on the same arrays, so the results are held equal to 1e-6
relative (they are the same NumPy calls); also the structured logger and the
decoded-sample cache, the two other NumPy-only copies.
"""

import json

import numpy as np
import pytest

from ssdseglib_tpu import evaluators as jax_eval
from ssdseglib_tpu.utils import sample_cache as jax_sample_cache

from ssdseglib_torch import evaluators
from ssdseglib_torch.utils import sample_cache
from ssdseglib_torch.utils.logging import MetricsLogger
from tests.test_evaluators import _random_eval_case, _write_gt_csvs
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)

CODES = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_threshold", [0.5, 0.7])
def test_average_precision_equals_jax_package(tmp_path, seed, iou_threshold):
    rng = np.random.default_rng(seed)
    gts, labels_pred, conf_pred, boxes_pred = _random_eval_case(rng)
    paths = _write_gt_csvs(tmp_path, gts)
    want = jax_eval.average_precision_object_detection(
        labels_pred, conf_pred, boxes_pred, iou_threshold, paths, CODES, 0)
    for sources in (paths, gts):  # CSV paths, and (labels, boxes) tuples
        got = evaluators.average_precision_object_detection(
            labels_pred, conf_pred, boxes_pred, iou_threshold, sources, CODES, 0)
        assert set(got) == set(want) == {1, 2, 3}
        for label in want:
            np.testing.assert_allclose(got[label], want[label], rtol=1e-6, atol=1e-9)
    assert any(v > 0 for v in want.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_soft_iou_equals_jax_package(tmp_path, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    n, h, w, c = 4, 24, 32, 4
    class_maps = rng.integers(0, c, size=(n, h, w)).astype(np.uint8)
    paths = []
    for i in range(n):
        p = tmp_path / f"mask{i}.png"
        Image.fromarray(class_maps[i], mode="L").save(p)
        paths.append(str(p))
    logits = rng.normal(size=(n, h, w, c)).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jax_eval.jaccard_iou_semantic_segmentation(pred, paths, CODES, 0)
    for sources in (paths, list(class_maps)):  # PNG paths, and class-map arrays
        got = evaluators.jaccard_iou_semantic_segmentation(pred, sources, CODES, 0)
        assert set(got) == set(want) == {1, 2, 3}
        for label in want:
            np.testing.assert_allclose(got[label], want[label], rtol=1e-6)


def test_no_predictions_and_no_ground_truth_give_zero():
    empty = evaluators.average_precision_object_detection(
        np.zeros((2, 3), np.int32), np.ones((2, 3), np.float32), np.zeros((2, 3, 4), np.float32),
        0.5, [(np.array([1]), np.array([[0, 0, 5, 5]])), (np.array([]), np.zeros((0, 4)))],
        CODES, 0)
    assert empty == {1: 0.0, 2: 0.0, 3: 0.0}


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "logs" / "metrics.jsonl"
    with MetricsLogger(str(path)) as logger:
        logger.log({"loss": 1.5, "iou/mask": np.float32(0.25)}, step=3)
        logger.log({"loss": 1.0}, step=6)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [3, 6]
    assert rows[0]["loss"] == 1.5 and abs(rows[0]["iou/mask"] - 0.25) < 1e-7


def test_sample_cache_behaves_like_the_jax_package(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(b"x" * (i + 1))
        files.append(str(p))
    value = (np.zeros((64, 64), np.uint8), np.ones((4,), np.float32))
    for module in (sample_cache, jax_sample_cache):
        cache = module.SampleCache(max_bytes=10_000)
        key = ("decoded", 16, cache.stat_key(*files))
        assert cache.enabled and cache.get(key) is None
        cache.put(key, value)
        hit = cache.get(key)
        assert hit is not None and np.array_equal(hit[0], value[0]) and len(cache) == 1
        for j in range(4):  # 4 KiB entries against a 10 kB budget: the oldest go
            cache.put(("other", j), (np.zeros((64, 64), np.uint8),))
        assert cache.get(key) is None and len(cache) <= 2
        assert cache.stat_key(str(tmp_path / "missing")) is None
        assert not module.SampleCache(max_bytes=0).enabled
