"""The port's shift-multiply depthwise conv (ops/depthwise.py) against the
JAX package's `depthwise_conv_shift` on the same inputs, f32 and bf16; its
gradients against the port's conv route; and a small MobileNetV2 served
under ``set_depthwise_impl("shift")`` in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_tpu.models import blocks as jax_blocks
from ssdseglib_tpu.ops.depthwise import depthwise_conv_shift as jax_shift
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.blocks import conv2d_same
from ssdseglib_torch.ops.depthwise import depthwise_conv_shift
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from tests.torch_parity import (  # noqa: F401
    SMALL_CFG,
    bf16_ulps,
    images,
    port_model_and_jax_variables,
    two_torch_threads,
)

F32_RTOL = 1e-6
BF16_ULPS = 2

# (H, W, C, stride, dilation, padding): SAME at stride 1 and 2 on odd and even
# sizes (stride 2 pads 0 before and 1 after on an even size), the dilations of
# the heads' atrous convs, and VALID
SHAPES = [(16, 24, 8, 1, 1, "SAME"), (16, 24, 8, 2, 1, "SAME"), (15, 21, 8, 2, 1, "SAME"),
          (12, 16, 8, 1, 3, "SAME"), (9, 11, 3, 2, 2, "VALID"), (13, 17, 5, 1, 2, "VALID")]


def _operands(seed, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, c)).astype(np.float32)
    return x, k


def _port(x, k, dtype, stride, dilation, padding):
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k).to(dtype).permute(3, 2, 0, 1)  # HWIO -> (C, 1, kh, kw)
    return depthwise_conv_shift(xt, kt, (stride, stride), (dilation, dilation),
                                padding).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,stride,dilation,padding", SHAPES)
def test_matches_jax_shift(h, w, c, stride, dilation, padding, dtype):
    x, k = _operands(h * w + c, h, w, c)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = jax_shift(jnp.asarray(x, jdt), jnp.asarray(k, jdt), (stride, stride),
                     (dilation, dilation), padding)
    got = _port(x, k, tdt, stride, dilation, padding)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=F32_RTOL)
    else:
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
        assert int(bf16_ulps(got, want).max()) <= BF16_ULPS


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_gradients_match_the_conv_route(stride, dilation):
    """Autograd through the shifted multiply-adds against the grouped conv's
    (SAME, `conv2d_same`): the input and weight gradients of sum(sin(y))."""
    x, k = _operands(stride + 7 * dilation, 12, 16, 6)
    grads = []
    for shift in (True, False):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        kt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
        if shift:
            y = depthwise_conv_shift(xt, kt, (stride, stride), (dilation, dilation))
        else:
            y = conv2d_same(xt, kt, None, stride, dilation, groups=6)
        torch.sin(y).sum().backward()
        grads.append((xt.grad, kt.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_set_depthwise_impl_validates():
    with pytest.raises(ValueError, match="depthwise impl"):
        blocks.set_depthwise_impl("fast")
    assert blocks.DEPTHWISE_IMPL == "conv"


def test_shift_takes_precedence_over_the_depthwise_backward_gate(monkeypatch):
    """As in the JAX package: under "shift" no depthwise conv reaches the
    backward kernel's route, whatever DEPTHWISE_BWD_IMPL says."""
    from ssdseglib_torch.ops import depthwise_backward

    def refuse(*args):
        raise AssertionError("the depthwise backward route was taken")

    monkeypatch.setattr(depthwise_backward, "depthwise_conv3x3_fused_bwd", refuse)
    conv = blocks.SameConv2d(32, 32, 3, groups=32)
    x = torch.randn(1, 32, 180, 180)  # inside the backward kernel's envelope
    monkeypatch.setattr(blocks, "DEPTHWISE_BWD_IMPL", "cuda")
    with pytest.raises(AssertionError, match="backward route"):
        blocks.depthwise_conv(conv, x)
    monkeypatch.setattr(blocks, "DEPTHWISE_IMPL", "shift")
    got = blocks.depthwise_conv(conv, x)
    np.testing.assert_allclose(got.detach().numpy(), conv(x).detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_model_under_shift_matches_jax_under_shift():
    """SMALL_CFG's MobileNetV2 in eval mode under "shift" in both packages,
    the JAX gate set for the call and restored; the port's "shift" against
    its "conv" too (the JAX package's own test's bound)."""
    model, variables = port_model_and_jax_variables(SMALL_CFG)
    module = JaxSsdSegModel(cfg=SMALL_CFG)
    x = images(4, (2, 96, 128, 3))
    try:
        jax_blocks.set_depthwise_impl("shift")
        want = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    finally:
        jax_blocks.set_depthwise_impl("conv")
    outputs = {}
    try:
        for impl in ("conv", "shift"):
            blocks.set_depthwise_impl(impl)
            with torch.no_grad():
                outputs[impl] = model(torch.from_numpy(x))
    finally:
        blocks.set_depthwise_impl("conv")
    for key in ("output-mask", "output-labels", "output-boxes"):
        got = outputs["shift"][key].numpy()
        np.testing.assert_allclose(got, np.asarray(want[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
        np.testing.assert_allclose(got, outputs["conv"][key].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_padding_argument_is_checked():
    x = torch.zeros(1, 2, 5, 5)
    k = torch.zeros(2, 1, 3, 3)
    with pytest.raises(ValueError, match="SOME"):
        depthwise_conv_shift(x, k, padding="SOME")
    with pytest.raises(ValueError, match="channels"):
        depthwise_conv_shift(x, torch.zeros(3, 1, 3, 3))
    explicit = depthwise_conv_shift(x + 1, k + 1, padding=((1, 1), (1, 1)))
    np.testing.assert_array_equal(explicit.numpy(),
                                  F.conv2d(x + 1, k + 1, padding=1, groups=2).numpy())
