"""The port's checkpoints (ssdseglib_torch/checkpoint.py): save / prune /
restore give the same `TrainState` bit for bit (bfloat16 moments included),
and the flat ``.npz`` export is the JAX package's: a file written by
``ssdseglib_tpu.checkpoint.save_params_npz`` loads into the port and back
with equal arrays, and a file written by the port loads in the JAX package.
All comparisons are exact: nothing is computed, only stored and laid out.
"""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from ssdseglib_tpu import checkpoint as jax_checkpoint

from ssdseglib_torch import checkpoint
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import AnchorsConfig, ModelConfig, TrainConfig
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.train import Trainer
from ssdseglib_torch.weights import (
    to_flax_variables,
    train_state_from_flax,
    train_state_to_flax,
)
from tests.torch_parity import (  # noqa: F401 (two_torch_threads: autouse fixture)
    SMALL_CFG,
    jax_model_and_variables,
    two_torch_threads,
)

ANCHORS = dict(
    feature_maps_shapes=((4, 4), (2, 2), (1, 1), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)
MODEL = ModelConfig(input_image_shape=(64, 64, 3), boxes_per_point=(4, 4, 4, 4))


def _trainer(**config):
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), (64, 64))
    model = SsdSegModel(MODEL, torch.Generator().manual_seed(0))
    return Trainer(model=model, anchors=anchors, config=TrainConfig(batch_size=2, **config),
                   device="cpu")


def _randomized_state(trainer, seed):
    """A state whose every tensor (moments and statistics too) is random."""
    gen = torch.Generator().manual_seed(seed)
    state = trainer.init_state(gen)
    state.step = 10 + seed
    for tensors in (state.batch_stats, state.opt_state.mu, state.opt_state.nu):
        for t in tensors.values():
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for name, x, y in (("params", a.params, b.params),
                       ("batch_stats", a.batch_stats, b.batch_stats),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        assert x.keys() == y.keys(), name
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].stride() == y[k].stride(), (name, k)
            assert torch.equal(x[k], y[k]), (name, k)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_save_restore_gives_the_same_state_bit_for_bit(tmp_path, mu_dtype):
    trainer = _trainer(adam_mu_dtype=mu_dtype)
    state = _randomized_state(trainer, 1)
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    ckpt.save(state.step, state)
    ckpt.wait_until_finished()
    template = trainer.init_state(torch.Generator().manual_seed(9))
    restored = ckpt.restore(template)
    _assert_states_equal(restored, state)
    assert restored.opt_state.mu["backbone.backbone-block0-expand.conv.weight"].dtype == getattr(
        torch, mu_dtype)
    # a new state, not views of the template or of the saved one
    restored.params["backbone.backbone-block0-expand.conv.weight"].zero_()
    assert template.params["backbone.backbone-block0-expand.conv.weight"].abs().sum() > 0
    assert state.params["backbone.backbone-block0-expand.conv.weight"].abs().sum() > 0
    # the saved values are a snapshot: later in-place updates do not reach the file
    state.params["backbone.backbone-block0-expand.conv.weight"].add_(1.0)
    again = checkpoint.Checkpointer(str(tmp_path / "ckpt")).restore(template)
    assert not torch.equal(again.params["backbone.backbone-block0-expand.conv.weight"],
                           state.params["backbone.backbone-block0-expand.conv.weight"])
    ckpt.close()


def test_oldest_steps_are_pruned_and_a_step_can_be_named(tmp_path):
    trainer = _trainer()
    ckpt = checkpoint.Checkpointer(str(tmp_path), max_to_keep=2)
    states = {}
    for step in (2, 4, 6):
        states[step] = _randomized_state(trainer, step)
        states[step].step = step
        ckpt.save(step, states[step])
    assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["step_00000004.pt", "step_00000006.pt"]
    template = trainer.init_state()
    _assert_states_equal(ckpt.restore(template), states[6])
    _assert_states_equal(ckpt.restore(template, step=4), states[4])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(template, step=2)
    assert inspect.signature(checkpoint.Checkpointer).parameters["max_to_keep"].default == 3


def test_restore_refuses_a_template_of_another_shape(tmp_path):
    ckpt = checkpoint.Checkpointer(str(tmp_path))
    ckpt.save(1, _randomized_state(_trainer(), 0))
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(_trainer(adam_mu_dtype="bfloat16").init_state())
    other = _trainer().init_state()
    del other.params["backbone.backbone-block0-expand.conv.weight"]
    with pytest.raises(ValueError, match="other tensors"):
        ckpt.restore(other)


def test_npz_of_the_jax_package_loads_into_the_port_and_back(tmp_path):
    _, variables = jax_model_and_variables(SMALL_CFG, seed=0)
    theirs = str(tmp_path / "theirs.npz")
    jax_checkpoint.save_params_npz(theirs, variables)
    model = SsdSegModel(ModelConfig(**vars(SMALL_CFG)), torch.Generator().manual_seed(3))
    loaded = checkpoint.load_params_npz(theirs, model.state_dict())
    model.load_state_dict(loaded, strict=True)  # every key, num_batches_tracked included
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    ours = str(tmp_path / "ours.npz")
    checkpoint.save_params_npz(ours, model.state_dict())
    with np.load(ours) as back:
        assert sorted(back.files) == sorted(flat)
        for name, value in flat.items():
            assert back[name].dtype == value.dtype and back[name].shape == value.shape, name
            np.testing.assert_array_equal(back[name], value, err_msg=name)
    # and the JAX package restores the port's file into its own tree
    restored = jax_checkpoint.load_params_npz(ours, variables)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        restored, variables)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_params_npz(theirs, SsdSegModel(MODEL, torch.Generator()).state_dict()
                                   | {"backbone.backbone-block0-expand.conv.weight":
                                      torch.zeros(1, 1, 1, 1)})


def test_a_whole_train_state_crosses_the_bridge_both_ways():
    trainer = _trainer(adam_mu_dtype="float32")
    state = _randomized_state(trainer, 4)
    tree = train_state_to_flax(state)
    assert set(tree) == {"step", "params", "batch_stats", "mu", "nu"} and tree["step"] == 14
    kernel = tree["mu"]["backbone"]["backbone-block0-expand"]["conv"]["kernel"]
    assert kernel.shape == (3, 3, 3, 32)  # HWIO, like the parameters
    variables = to_flax_variables(state.variables())
    np.testing.assert_array_equal(
        tree["params"]["backbone"]["backbone-block0-expand"]["conv"]["kernel"],
        variables["params"]["backbone"]["backbone-block0-expand"]["conv"]["kernel"])
    other = trainer.init_state(torch.Generator().manual_seed(8))
    assert train_state_from_flax(tree, other) is other
    _assert_states_equal(other, state)
