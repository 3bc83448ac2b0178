"""The port's input pipeline (ssdseglib_torch/data/pipeline.py) against
ssdseglib_tpu/data/pipeline.py on the CPU: the same batches in the same order
for a seed (exact: both shuffle with ``np.random.default_rng(seed)``),
producer errors reach the consumer, the trailing partial batch is dropped,
and `TrainDataLoader` runs the device transform on what the batcher yields.
"""

import inspect
import json
import threading
import time

import numpy as np
import pytest
import torch

from ssdseglib_tpu.data import pipeline as jax_pipeline
from ssdseglib_tpu.data.synthetic import SyntheticSample as JaxSyntheticSample

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import AnchorsConfig, EncodingConfig
from ssdseglib_torch.data import pipeline
from ssdseglib_torch.data.synthetic import generate_dataset
from tests.test_pipeline_robustness import _write_sample
from tests.test_torch_transform import ANCHORS, ENCODING, IMAGE_SHAPE
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)


def _as_jax_samples(samples):
    return [JaxSyntheticSample(s.image, s.mask, s.labels, s.boxes) for s in samples]


@pytest.mark.parametrize("seed, shuffle", [(0, True), (7, True), (0, False)])
def test_batches_equal_the_jax_batcher_for_a_seed(seed, shuffle):
    samples = generate_dataset(11, image_shape=(24, 32), seed=1)
    kwargs = dict(batch_size=4, max_ground_truth_boxes=8, shuffle=shuffle, seed=seed,
                  num_workers=2)
    ours = pipeline.HostBatcher(samples, **kwargs)
    theirs = jax_pipeline.HostBatcher(_as_jax_samples(samples), use_native=False, **kwargs)
    assert len(ours) == len(theirs) == 2  # 11 // 4: the partial batch is dropped
    for epoch in range(2):  # the shuffle stream goes on across epochs
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert len(a) == len(b) == 5
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    first = next(iter(pipeline.HostBatcher(samples, **kwargs)))
    assert first[0].shape == (4, 24, 32, 3) and first[0].dtype == np.uint8
    assert first[1].shape == (4, 24, 32) and first[3].shape == (4, 8, 4)


def test_batches_from_files_equal_the_jax_batcher(tmp_path):
    triples = [_write_sample(tmp_path, i) for i in range(5)]
    kwargs = dict(batch_size=2, shuffle=True, seed=3, image_shape=(16, 24), num_workers=2)
    ours = pipeline.HostBatcher(triples, **kwargs)
    theirs = jax_pipeline.HostBatcher(triples, use_native=False, **kwargs)
    for epoch in range(2):  # the second epoch is served from the sample cache
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # the dataset JSON of the reference layout resolves the same way
    listing = tmp_path / "listing.json"
    listing.write_text(json.dumps([[p.rsplit("/", 1)[1] for p in t] for t in triples]))
    assert pipeline.load_dataset_json(str(listing)) == jax_pipeline.load_dataset_json(
        str(listing)) == [tuple(t) for t in triples]


def test_producer_error_reaches_the_consumer(tmp_path):
    triples = [_write_sample(tmp_path, i) for i in range(4)]
    triples.append((str(tmp_path / "missing.png"), triples[0][1], triples[0][2]))
    batcher = pipeline.HostBatcher(triples, batch_size=1, shuffle=False, image_shape=(16, 24))
    seen = 0
    with pytest.raises((FileNotFoundError, OSError)):
        for _ in batcher:
            seen += 1
    assert seen == 4  # the good batches came through first


def test_early_consumer_exit_unblocks_producer(tmp_path):
    triples = [_write_sample(tmp_path, i) for i in range(8)]
    before = {t.ident for t in threading.enumerate()}
    batcher = pipeline.HostBatcher(triples, batch_size=1, shuffle=False, image_shape=(16, 24),
                                   prefetch=1)
    for _ in batcher:
        break  # abandon the epoch with the queue full
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if not [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]:
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"producer never exited: {threading.enumerate()}")


def test_fewer_samples_than_a_batch_and_the_native_loader():
    samples = generate_dataset(3, image_shape=(24, 32), seed=1)
    assert list(pipeline.HostBatcher(samples, batch_size=4)) == []
    # the native assembler is the default, as in the JAX package; it reads
    # files, so in-memory samples take the Python path
    assert inspect.signature(pipeline.HostBatcher).parameters["use_native"].default is True
    batcher = pipeline.HostBatcher(samples, batch_size=2, use_native=True, image_shape=(24, 32))
    assert batcher._native is None and len(list(batcher)) == 1


def test_the_partial_batch_is_kept_on_request():
    """``drop_remainder=False`` yields the trailing partial batch, as the
    reference's ``tf.data`` ``batch`` does: 11 samples in batches of 4 are
    three batches (4, 4, 3) holding each sample once; by default the two
    full batches, as the JAX package's batcher gives."""
    samples = generate_dataset(11, image_shape=(16, 24), seed=2)
    kwargs = dict(batch_size=4, seed=5, image_shape=(16, 24), max_ground_truth_boxes=8)
    kept = pipeline.HostBatcher(samples, drop_remainder=False, **kwargs)
    batches = list(kept)
    assert len(kept) == 3 and [len(b[0]) for b in batches] == [4, 4, 3]
    images = np.concatenate([b[0] for b in batches])
    assert sorted(map(bytes, images)) == sorted(bytes(s.image) for s in samples)
    dropped = pipeline.HostBatcher(samples, **kwargs)
    assert len(dropped) == 2 and [len(b[0]) for b in dropped] == [4, 4]


def test_train_data_loader_iterates_transformed_batches_and_raw_ones():
    samples = generate_dataset(9, image_shape=IMAGE_SHAPE, seed=5)
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)

    def loader(**kwargs):
        return pipeline.TrainDataLoader(
            samples, anchors, EncodingConfig(**ENCODING), batch_size=4, seed=2, num_workers=2,
            device="cpu", **kwargs)

    augmented = dict(augmentation_horizontal_flip=True, augmentation_rgb=True)
    a, b = loader(**augmented), loader(**augmented)
    assert len(a) == 2
    batches = list(a)
    assert len(batches) == 2
    images, targets = batches[0]
    assert tuple(images.shape) == (4, 96, 128, 3) and images.dtype == torch.float32
    assert tuple(targets["output-mask"].shape) == (4, 96, 128, 4)
    assert targets["output-labels"].shape[:2] == targets["output-boxes"].shape[:2]
    # iter_raw + transform is the same stream as __iter__: same seed, same batches
    for (images, targets), (rng, raw) in zip(batches, b.iter_raw()):
        assert all(isinstance(x, np.ndarray) for x in raw) and raw[0].dtype == np.uint8
        again_images, again = b.transform(rng, *raw)
        assert torch.equal(images, again_images)
        assert all(torch.equal(targets[k], again[k]) for k in targets)
    # without augmentation the images are the samples' own pixels
    plain = loader(shuffle=False)
    images, _ = next(iter(plain))
    np.testing.assert_array_equal(images.numpy(),
                                  np.stack([s.image for s in samples[:4]]).astype(np.float32))
    assert inspect.signature(pipeline.TrainDataLoader).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pipeline.TrainDataLoader(samples, anchors, EncodingConfig(**ENCODING), batch_size=4)


def test_upload_batch_keeps_values_and_dtypes():
    raw = (np.arange(24, dtype=np.uint8).reshape(2, 3, 4), np.ones((2, 3), bool),
           np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2])  # one non-contiguous
    out = pipeline.upload_batch(raw, torch.device("cpu"))
    for t, a in zip(out, raw):
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
