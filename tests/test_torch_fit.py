"""The port's whole training run on the CPU: `Trainer.fit` over a
`TrainDataLoader` (transform-fused steps, chunked staging), checkpoints and
resume, against ssdseglib_tpu's `fit` at the small configuration of
tests/test_torch_train.py.

- Two epochs of `fit` over a `TrainDataLoader` of 16 synthetic samples (same
  seed, so the same shuffled batches; augmentation off, so no random stream
  has to match) give the JAX `fit`'s per-epoch loss history within rtol 5e-3,
  the trajectory bar of tests/test_torch_train.py (parameters with vanishing
  gradients drift by up to lr a step).
- The fused step equals transform-then-`train_step`: exact, it is the same
  arithmetic.
- `fit(resume=True)` continues where the checkpoint stopped: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig as JaxAnchorsConfig
from ssdseglib_tpu.config import EncodingConfig as JaxEncodingConfig
from ssdseglib_tpu.config import ModelConfig as JaxModelConfig
from ssdseglib_tpu.config import TrainConfig as JaxTrainConfig
from ssdseglib_tpu.data.pipeline import TrainDataLoader as JaxTrainDataLoader
from ssdseglib_tpu.data.synthetic import SyntheticSample as JaxSyntheticSample
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_tpu.models.builder import TrainableModel
from ssdseglib_tpu.train import Trainer as JaxTrainer
from ssdseglib_tpu.train import TrainState as JaxTrainState

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.checkpoint import Checkpointer
from ssdseglib_torch.config import AnchorsConfig, EncodingConfig, ModelConfig, TrainConfig
from ssdseglib_torch.data.pipeline import TrainDataLoader
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.train import Trainer
from ssdseglib_torch.utils.logging import MetricsLogger
from ssdseglib_torch.weights import from_flax_variables
from tests.torch_parity import randomize_batchnorm, two_torch_threads  # noqa: F401

IMAGE_SHAPE = (96, 128)
BATCH = 8
ANCHORS = dict(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)
MODEL = dict(
    input_image_shape=(96, 128, 3),
    number_of_classes=4,
    boxes_per_point=(4, 4, 4, 4),
    backbone="mobilenetv2",
    segmentation_dilation_rates=(3, 6, 12),
)
ENCODING = dict(num_classes=4, image_shape=IMAGE_SHAPE, iou_threshold=0.35,
                max_ground_truth_boxes=16)
TRAIN = dict(batch_size=BATCH, learning_rate=3e-4, epochs=1)


@pytest.fixture(scope="module")
def samples():
    return generate_dataset(2 * BATCH, image_shape=IMAGE_SHAPE, seed=3)


def _trainer(**overrides):
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    model = SsdSegModel(ModelConfig(**MODEL), torch.Generator().manual_seed(0))
    return Trainer(model=model, anchors=anchors, config=TrainConfig(**{**TRAIN, **overrides}),
                   device="cpu")


def _loader(samples, **kwargs):
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    return TrainDataLoader(samples, anchors, EncodingConfig(**ENCODING), batch_size=BATCH,
                           seed=0, num_workers=2, device="cpu", **kwargs)


def test_two_epochs_of_fit_match_the_jax_fit_loss_history(samples):
    cfg = JaxModelConfig(**MODEL)
    jax_anchors = JaxAnchors.from_config(JaxAnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    jax_model = TrainableModel(module=JaxSsdSegModel(cfg=cfg), cfg=cfg)
    jax_trainer = JaxTrainer(model=jax_model, anchors=jax_anchors,
                             config=JaxTrainConfig(**TRAIN))
    variables = randomize_batchnorm(jax.device_get(jax_model.init(jax.random.key(0))))
    jax_loader = JaxTrainDataLoader(
        [JaxSyntheticSample(s.image, s.mask, s.labels, s.boxes) for s in samples],
        jax_anchors, JaxEncodingConfig(**ENCODING), batch_size=BATCH, seed=0, num_workers=2)
    jax_state = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, variables),
                                     jax_trainer.tx)
    jax_state, jax_history = jax_trainer.fit(jax_state, jax_loader, epochs=2,
                                             log_fn=lambda line: None)

    trainer = _trainer()
    state = trainer.init_state(variables=from_flax_variables(variables))
    logs = []
    state, history = trainer.fit(state, _loader(samples), epochs=2, log_fn=logs.append)
    assert state.step == int(np.asarray(jax_state.step)) == 4
    assert set(history) == set(jax_history) and len(logs) == 2
    for key in ("loss", "loss/mask", "loss/labels", "loss/boxes"):
        assert len(history[key]) == 2
        np.testing.assert_allclose(history[key], jax_history[key], rtol=5e-3, err_msg=key)
    assert history["loss"][1] < history["loss"][0]
    assert jax_history["loss"][1] < jax_history["loss"][0]


def test_fused_step_equals_transform_then_train_step(samples):
    loader = _loader(samples, augmentation_horizontal_flip=True, augmentation_rgb=True)
    twin = _loader(samples, augmentation_horizontal_flip=True, augmentation_rgb=True)
    trainer = _trainer()
    fused = trainer.fused_train_step_fn(loader.transform)
    assert trainer.fused_train_step_fn(loader.transform) is fused  # cached by the transform
    assert trainer.fused_train_step_fn(twin.transform) is not fused
    assert trainer._fused_steps[("train", id(loader.transform))][0] is loader.transform
    fused_eval = trainer.fused_eval_step_fn(loader.transform)
    assert fused_eval is not fused
    a = trainer.init_state(torch.Generator().manual_seed(1))
    b = trainer.init_state(torch.Generator().manual_seed(1))
    for (rng, raw), (images, targets) in zip(loader.iter_raw(), twin):
        a, fused_metrics = fused(a, rng, *raw)
        b, metrics = trainer.train_step(b, images, targets)
        for k in metrics:
            assert torch.equal(fused_metrics[k], metrics[k]), k
    assert a.step == b.step == 2
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    # and the eval twin
    rng, raw = next(iter(loader.iter_raw()))
    images, targets = next(iter(twin))
    fused_metrics = fused_eval(a, rng, *raw)
    for k, v in trainer.eval_step(b, images, targets).items():
        assert torch.equal(fused_metrics[k], v), k


def test_staged_upload_keeps_order_and_flushes_the_tail(samples):
    trainer = _trainer()
    raw = [(i, (np.full((2, 3), i, np.uint8), np.full((2,), i, np.float32)))
           for i in range(19)]  # two chunks of 8 and a tail of 3
    staged = list(trainer._staged(iter(raw)))
    assert [rng for rng, _ in staged] == list(range(19))
    for i, (_, batch) in enumerate(staged):
        assert all(isinstance(t, torch.Tensor) for t in batch)
        assert batch[0].dtype == torch.uint8 and int(batch[0][0, 0]) == i
    assert list(trainer._staged(iter(()))) == []
    # a loader is read a chunk ahead of the steps, never further
    pulled = []

    def source():
        for item in raw:
            pulled.append(item[0])
            yield item

    it = trainer._staged(source(), chunk_size=4)
    next(it)
    assert pulled == [0, 1, 2, 3]


def test_fit_with_checkpointer_resume_and_logger(samples, tmp_path):
    directory = str(tmp_path / "ckpt")
    trainer = _trainer()
    state = trainer.init_state(torch.Generator().manual_seed(2))
    with MetricsLogger(str(tmp_path / "metrics.jsonl")) as logger:
        state, history = trainer.fit(
            state, _loader(samples), epochs=2, validation_data=_loader(samples, shuffle=False),
            checkpointer=Checkpointer(directory, max_to_keep=5), metrics_logger=logger,
            log_fn=lambda line: None)
    assert state.step == 4 and Checkpointer(directory).all_steps() == [2, 4]
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [2, 4]
    assert records[1]["loss"] == history["loss"][1]
    assert records[1]["val_loss"] == history["val_loss"][1]

    # a fresh process: other weights, resumed to the saved state, then on
    fresh_trainer = _trainer()
    fresh = fresh_trainer.init_state(torch.Generator().manual_seed(99))
    restored = Checkpointer(directory).restore(fresh)
    assert restored.step == 4
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k]), k
        assert torch.equal(restored.opt_state.nu[k], state.opt_state.nu[k]), k
    messages = []
    resumed, more = fresh_trainer.fit(fresh, _loader(samples), epochs=1, resume=True,
                                      checkpointer=Checkpointer(directory, max_to_keep=5),
                                      log_fn=messages.append)
    assert messages[0] == "resumed from checkpoint step 4"
    assert resumed.step == 6 and Checkpointer(directory).all_steps() == [2, 4, 6]
    # the same continuation as going on without a crash (same loader seed and
    # epoch: `fit` is deterministic on the CPU)
    straight, straight_more = trainer.fit(state, _loader(samples), epochs=1,
                                          log_fn=lambda line: None)
    assert straight_more["loss"] == more["loss"]
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
    # an empty directory: resume starts from the state it was given
    empty = Checkpointer(str(tmp_path / "empty"))
    begun, _ = fresh_trainer.fit(fresh_trainer.init_state(), _loader(samples), epochs=1,
                                 resume=True, checkpointer=empty, steps_per_epoch=1,
                                 log_fn=messages.append)
    assert begun.step == 1 and empty.all_steps() == [1]
    assert not any("resumed" in m for m in messages[1:])
