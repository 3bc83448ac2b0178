"""Mixed-precision (bf16) training's BatchNorm running statistics over
several steps: the port's Trainer against ssdseglib_tpu.train.Trainer on
the CPU, at the small configuration of tests/test_torch_train.py (96x128,
batch 8), from the same weights and randomised statistics on the same batch.

The learning rate is 0, so the weights stay as they are, every step sees the
same batch statistics, and what is compared is the running statistics'
recursion alone: in the JAX package's compiled step, f32(bf16(0.99)) *
f32(bf16(old)) + 0.01 * batch.  Its bf16 momentum (0.98828125) and the
rounding of the old statistic each step are what make bf16 training serve
differently from f32 training, so a port whose recursion differs would serve
differently from the JAX package.

Tolerances (per statistic tensor, the norm of the difference over the norm of
the JAX package's tensor): the median over the network's 140 tensors at most
2e-3 and the largest at most 1e-2.  The batch statistics themselves differ
between XLA's and oneDNN's bf16 networks by up to 5e-2 relative in the
deepest layers, and after 8 steps they make up 0.077 of the statistic
(measured: median 5.0e-4, largest 3.8e-3).  An update in f32 (0.99 kept, no
rounding) or with the product rounded to bf16 too (Flax run op by op) is
1.7e-2 away in the median and must fail.
"""

import jax
import numpy as np
import pytest
import torch

from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig, ModelConfig
from ssdseglib_tpu.config import TrainConfig as JaxTrainConfig
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_tpu.models.builder import TrainableModel
from ssdseglib_tpu.train import Trainer as JaxTrainer

from ssdseglib_torch.models.blocks import BN_MOMENTUM
from ssdseglib_torch.weights import from_flax_variables, to_flax_variables
from tests.test_torch_train import (  # noqa: F401 (the batch fixture)
    ANCHORS_CFG,
    IMAGE_SHAPE,
    MODEL_CFG,
    TRAIN_CFG,
    _flat,
    _jax_state,
    _port_trainer,
    batch,
)
from tests.torch_parity import randomize_batchnorm, two_torch_threads  # noqa: F401

STEPS = 8
CONFIG = dict(TRAIN_CFG, learning_rate=0.0, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def start():
    cfg = ModelConfig(**MODEL_CFG)
    model = TrainableModel(module=JaxSsdSegModel(cfg=cfg), cfg=cfg)
    return model, randomize_batchnorm(jax.device_get(model.init(jax.random.key(0))))


@pytest.fixture(scope="module")
def jax_statistics(start, batch):
    model, variables = start
    anchors = JaxAnchors.from_config(AnchorsConfig(**ANCHORS_CFG), IMAGE_SHAPE)
    trainer = JaxTrainer(model=model, anchors=anchors, config=JaxTrainConfig(**CONFIG))
    step = trainer.train_step_fn()
    images, targets = batch
    state = _jax_state(trainer, variables)
    for _ in range(STEPS):
        state, _ = step(state, images, targets)
    return _flat({"batch_stats": jax.device_get(state.batch_stats)})


def _port_statistics(variables, batch, working=None):
    """The running statistics after STEPS steps of the port's Trainer;
    ``working(old)`` replaces the working statistics it prepares."""
    trainer = _port_trainer(learning_rate=0.0, compute_dtype="bfloat16")
    if working is not None:
        prepare = trainer._compute_variables

        def compute_variables(params, batch_stats):
            leaves, _ = prepare(params, batch_stats)
            return leaves, {k: working(v) for k, v in batch_stats.items()}

        trainer._compute_variables = compute_variables
    state = trainer.init_state(variables=from_flax_variables(variables))
    images, targets = batch
    for _ in range(STEPS):
        state, _ = trainer.train_step(state, images, targets)
    return _flat({"batch_stats": to_flax_variables(state.variables())["batch_stats"]})


def _relative_errors(got, want):
    assert set(got) == set(want) and len(want) == 140
    return np.array([np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]) for k in want])


def test_bf16_running_statistics_track_the_jax_step_over_steps(start, batch, jax_statistics):
    _, variables = start
    before = _flat({"batch_stats": variables["batch_stats"]})
    moved = _relative_errors(before, jax_statistics)
    assert np.median(moved) > 5e-2  # the steps moved the statistics
    errors = _relative_errors(_port_statistics(variables, batch), jax_statistics)
    assert np.median(errors) <= 2e-3 and errors.max() <= 1e-2, (np.median(errors), errors.max())


@pytest.mark.parametrize("update", ["f32", "product_rounded"])
def test_other_bf16_statistics_updates_fail_the_comparison(start, batch, jax_statistics, update):
    """What the comparison above tells apart: an EMA kept in f32 with the
    momentum 0.99, and Flax's update run op by op (the product of the bf16
    momentum and the rounded old statistic rounded to bf16 again)."""
    _, variables = start
    keep = 1.0 - BN_MOMENTUM
    kept = float(torch.tensor(keep, dtype=torch.bfloat16))
    working = {
        "f32": lambda old: old.clone(),
        "product_rounded": lambda old: (old.bfloat16() * kept).float() / keep,
    }[update]
    errors = _relative_errors(_port_statistics(variables, batch, working), jax_statistics)
    assert np.median(errors) > 5e-3, np.median(errors)
