"""The port's eval-mode SsdSegModel against the JAX SsdSegModel.apply
(train=False), on the same bridged weights and inputs, f32 on the CPU;
plus the conv padding and resize conventions it rests on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_torch.models.blocks import bilinear_resize, conv2d_same
from tests.torch_parity import SMALL_CFG, images, jax_model_and_variables, port_model


@pytest.fixture(scope="module")
def models():
    module, variables = jax_model_and_variables(SMALL_CFG)
    return module, variables, port_model(SMALL_CFG, variables)


def _compare(expected, got, tol):
    for key in ("output-mask", "output-labels", "output-boxes"):
        assert tuple(got[key].shape) == tuple(expected[key].shape), key
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(expected[key]), rtol=tol, atol=tol,
            err_msg=key,
        )


def test_model_matches_jax_96x128(models):
    module, variables, port = models
    x = images(1, (2, 96, 128, 3))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert float(np.asarray(expected["output-mask"]).std()) > 0.01  # not degenerate
    _compare(expected, got, 1e-4)


def test_model_matches_jax_480x640(models):
    """The flagship size, where the stride-2 SAME padding of the extra
    pyramid blocks bites (15x20 -> 8x10 pads (1,1)/(0,1); 8x10 -> 4x5 pads
    (0,1)/(0,1)) and the stem pads (0,1) on both axes."""
    from ssdseglib_tpu.models.builder import SsdSegModel

    _, variables, _ = models
    cfg = dataclasses.replace(SMALL_CFG, input_image_shape=(480, 640, 3))
    module = SsdSegModel(cfg=cfg)
    x = images(2, (1, 480, 640, 3))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port_model(cfg, variables)(torch.from_numpy(x))
    assert got["output-labels"].shape == (1, 9600, 4)
    _compare(expected, got, 1e-4)


@pytest.mark.parametrize(
    "hw,kernel,stride,dilation,depthwise",
    [
        ((15, 20), 3, 2, 1, True),  # extra block 17: pads (1,1) / (0,1)
        ((8, 10), 3, 2, 1, True),  # extra block 18: pads (0,1) / (0,1)
        ((480, 640), 3, 2, 1, False),  # stem: pads (0,1) / (0,1)
        ((30, 40), 3, 1, 12, True),  # ASPP atrous: pads by the rate
        ((15, 21), 3, 2, 1, False),
    ],
)
def test_conv2d_same_matches_xla_same(hw, kernel, stride, dilation, depthwise):
    rng = np.random.default_rng(0)
    c = 8
    x = rng.normal(size=(1,) + hw + (c,)).astype(np.float32)
    k = rng.normal(size=(kernel, kernel, 1 if depthwise else c, c)).astype(np.float32)
    expected = jax.lax.conv_general_dilated(
        x, k, (stride, stride), "SAME", rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c if depthwise else 1,
    )
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = conv2d_same(xt, kt, None, stride, dilation, c if depthwise else 1)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5
    )
    if stride == 2 and hw[0] % 2 == 0:
        # torch's symmetric padding=1 shifts every output by a pixel
        naive = F.conv2d(xt, kt, None, stride, 1, dilation, c if depthwise else 1)
        assert not np.allclose(naive.permute(0, 2, 3, 1).numpy(), np.asarray(expected),
                               atol=1e-3)


@pytest.mark.parametrize("src,dst", [((30, 40), (120, 160)), ((120, 160), (480, 640)),
                                     ((4, 5), (15, 20))])
def test_bilinear_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).normal(size=(2,) + src + (3,)).astype(np.float32)
    expected = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), method="bilinear")
    got = bilinear_resize(torch.from_numpy(x).permute(0, 3, 1, 2), *dst)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5
    )
