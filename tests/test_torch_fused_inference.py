"""The port's BN-folded serving forward against the JAX package's
make_fused_forward (Pallas kernels in interpret mode), f32 on the CPU, and
the host-side folds against their NumPy originals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.models import fused_inference as tpu_fused
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.models import fused_inference as port_fused
from tests.torch_parity import SMALL_CFG, images, jax_model_and_variables, port_model

PORT_CFG = PortModelConfig(**vars(SMALL_CFG))


@pytest.fixture(scope="module")
def setup():
    module, variables = jax_model_and_variables(SMALL_CFG)
    state = port_model(SMALL_CFG, variables).state_dict()
    forward = port_fused.make_fused_forward(PORT_CFG, state, torch.float32)
    return module, variables, state, forward


def _compare(expected, got, tol):
    for key in ("output-mask", "output-labels", "output-boxes"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(expected[key]), rtol=tol, atol=tol,
            err_msg=key,
        )


def test_fused_forward_matches_jax_fused_forward(setup):
    _, variables, _, forward = setup
    x = images(1, (2, 96, 128, 3))
    expected = tpu_fused.make_fused_forward(
        SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True
    )(jnp.asarray(x))
    got = forward(torch.from_numpy(x))
    _compare(expected, got, 2e-3)  # the JAX package's own bound


def test_fused_forward_uint8_input_matches_float(setup):
    _, _, _, forward = setup
    x8 = images(5, (2, 96, 128, 3), np.uint8)
    got8 = forward(torch.from_numpy(x8))
    gotf = forward(torch.from_numpy(x8.astype(np.float32)))
    for key in gotf:
        np.testing.assert_allclose(got8[key].numpy(), gotf[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_fused_forward_off_shape_input_bypasses_rescale_fold(setup):
    """The stem's border bias map is specific to cfg.input_image_shape; any
    other spatial shape takes the standalone rescale and still matches."""
    module, variables, _, forward = setup
    x = images(4, (2, 64, 96, 3))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    _compare(expected, forward(torch.from_numpy(x)), 2e-3)


@pytest.mark.parametrize("input_hw", [(480, 640), (96, 128), (15, 21)])
def test_fold_stem_rescale_equals_numpy_original(setup, input_hw):
    _, _, state, _ = setup
    k, b = port_fused.fold_mobilenetv2(state)["backbone-block0-expand"]
    k_jax, b_jax = k.transpose(2, 3, 1, 0), b  # OIHW -> HWIO
    kernel, bias_map = port_fused.fold_stem_rescale(k, b, input_hw)
    kernel_jax, bias_map_jax = tpu_fused.fold_stem_rescale(k_jax, b_jax, input_hw)
    np.testing.assert_array_equal(kernel.transpose(2, 3, 1, 0), kernel_jax)
    np.testing.assert_array_equal(bias_map.transpose(0, 2, 3, 1), bias_map_jax)


def test_folds_equal_jax_folds(setup):
    _, variables, state, _ = setup
    ours = port_fused.fold_mobilenetv2(state)
    theirs = tpu_fused.fold_mobilenetv2(variables)
    assert sorted(ours) == sorted(theirs)
    for name, (k, b) in theirs.items():
        np.testing.assert_array_equal(ours[name][0].transpose(2, 3, 1, 0), k)
        np.testing.assert_array_equal(ours[name][1], b)
    ours = port_fused.fold_heads(state, PORT_CFG)
    theirs = tpu_fused.fold_heads(variables, SMALL_CFG)
    assert sorted(ours) == sorted(theirs)
    for name, arrays in theirs.items():
        for a, b in zip(ours[name], arrays):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_fused_forward_rejects_shufflenet(setup):
    _, _, state, _ = setup
    with pytest.raises(ValueError):
        port_fused.make_fused_forward(PortModelConfig(backbone="shufflenetv2"), state)
