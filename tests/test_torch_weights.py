"""Weight bridge between the Flax variables tree and the port's state_dict,
and the port's own init, on the flagship (warehouse, 480x640) tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ssdseglib_tpu.config import reference_warehouse_config
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_torch import config as port_config
from ssdseglib_torch.models.builder import SsdSegModel, count_parameters
from ssdseglib_torch.weights import from_flax_variables, to_flax_variables

# published parameter counts (BASELINE.md / reference nb 03 cell 12)
REF_TRAINABLE = 4_009_920
REF_TOTAL = 4_047_408


@pytest.fixture(scope="module")
def flagship_shapes():
    """Shapes of the flagship Flax tree (abstract init, no compute)."""
    cfg = reference_warehouse_config()[2]
    module = JaxSsdSegModel(cfg=cfg)
    return jax.eval_shape(
        lambda key: module.init(key, jnp.zeros((1, 480, 640, 3)), train=False),
        jax.random.key(0),
    )


@pytest.fixture(scope="module")
def flagship_tree(flagship_shapes):
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), flagship_shapes
    )


@pytest.fixture(scope="module")
def port_flagship():
    cfg = port_config.reference_warehouse_config()[2]
    return SsdSegModel(cfg, torch.Generator().manual_seed(0))


def _flat(tree):
    return {"/".join(k): v for k, v in flatten_dict(tree).items()}


def test_port_init_has_flax_keys_shapes_and_counts(flagship_shapes, port_flagship):
    ours = _flat(to_flax_variables(port_flagship.state_dict()))
    theirs = _flat(flagship_shapes)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].shape == value.shape, key
    trainable, stats = count_parameters(port_flagship)
    assert trainable == REF_TRAINABLE
    assert trainable + stats == REF_TOTAL


def test_round_trip_is_bit_identical(flagship_tree):
    back = _flat(to_flax_variables(from_flax_variables(flagship_tree)))
    orig = _flat(jax.tree_util.tree_map(np.asarray, flagship_tree))
    assert sorted(back) == sorted(orig)
    for key, value in orig.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_npz_mapping_bridges_like_the_tree(flagship_tree, tmp_path):
    """The flat '/'-keyed npz that checkpoint.save_params_npz writes
    bridges to the same state_dict as the nested tree."""
    from ssdseglib_tpu.checkpoint import save_params_npz

    path = tmp_path / "weights.npz"
    save_params_npz(str(path), flagship_tree)
    with np.load(path) as data:
        from_npz = from_flax_variables(dict(data))
    from_tree = from_flax_variables(flagship_tree)
    assert sorted(from_npz) == sorted(from_tree)
    for key, value in from_tree.items():
        assert torch.equal(from_npz[key], value), key


def test_kernel_layouts(flagship_tree, port_flagship):
    state = from_flax_variables(flagship_tree)
    # dense conv: HWIO -> OIHW
    k = np.asarray(
        flagship_tree["params"]["backbone"]["backbone-block0-expand"]["conv"]["kernel"]
    )
    assert k.shape == (3, 3, 3, 32)
    w = state["backbone.backbone-block0-expand.conv.weight"].numpy()
    assert w.shape == (32, 3, 3, 3)
    np.testing.assert_array_equal(w[5, 2, 0, 1], k[0, 1, 2, 5])
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
    # depthwise: (3, 3, 1, C) -> (C, 1, 3, 3)
    k = np.asarray(
        flagship_tree["params"]["backbone"]["backbone-block1-depthwise"]["conv"]["kernel"]
    )
    w = state["backbone.backbone-block1-depthwise.conv.weight"].numpy()
    assert k.shape == (3, 3, 1, 96) and w.shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(w[:, 0], k[:, :, 0].transpose(2, 0, 1))
    # BatchNorm: scale/bias -> weight/bias, batch_stats mean/var -> running_*
    bn = flagship_tree["batch_stats"]["mask-encoder"]["aspp-atrous1"]["batchnorm"]
    np.testing.assert_array_equal(
        state["mask-encoder.aspp-atrous1.batchnorm.running_var"].numpy(),
        np.asarray(bn["var"]),
    )
    # and the bridged state loads into the port's module strictly
    fresh = SsdSegModel(port_flagship.cfg, torch.Generator().manual_seed(1))
    fresh.load_state_dict(state, strict=True)


def test_batchnorm_hyperparameters_and_init(port_flagship):
    """BN eps 1e-3 and torch momentum 0.01 (= 1 - Flax's 0.99); convs
    drawn lecun-normal from the generator, reproducibly."""
    bns = [m for m in port_flagship.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-3 and m.momentum == 0.01 for m in bns)
    w = port_flagship["mask-encoder"]["output"].conv.weight.detach()  # fan_in 1280
    assert abs(float(w.std()) - 1280 ** -0.5) < 0.05 * 1280 ** -0.5
    assert float(w.abs().max()) <= 2 * 1280 ** -0.5 / 0.87962566103423978 + 1e-6
    again = SsdSegModel(port_flagship.cfg, torch.Generator().manual_seed(0))
    for (name, a), b in zip(port_flagship.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
