"""The plain version of the port's fused stem + block 1 kernel against the
JAX package on the same folded convs and images: the Pallas kernel in
interpret mode and the six-conv composition, f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.models.fused_inference import _conv
from ssdseglib_tpu.ops.s2d_stem import fused_s2d_stem_block1
from ssdseglib_torch.models import fused_inference as port_fused
from ssdseglib_torch.ops import s2d_stem
from tests.torch_parity import make_stem_folded, port_folded

F32_TOL = 2e-5  # the JAX package's own bound between its kernel and its convs
BF16_ULPS = 2 * 2.0 ** -8  # two bf16 ulps, relative


def jax_six_convs(folded, x):
    """Stem and block 1 as the JAX package's plain folded path runs them."""
    def convs(block):
        return (folded[f"backbone-block{block}-{stage}"]
                for stage in ("expand", "depthwise", "project"))

    (we, be), (wd, bd), (wp, bp) = convs(0)
    x = _conv(x, we, be, stride=2, relu6=True)
    x = _conv(x, wd, bd, depthwise=True, relu6=True)
    x = _conv(x, wp, bp)
    (we, be), (wd, bd), (wp, bp) = convs(1)
    e = _conv(x, we, be, relu6=True)
    d = _conv(e, wd, bd, stride=2, depthwise=True, relu6=True)
    return _conv(d, wp, bp)


def _port(folded, x, dtype=torch.float32):
    args = s2d_stem.stem_block1_args(port_folded(folded, dtype))
    images = torch.from_numpy(x).to(dtype)
    out = s2d_stem.fused_stem_block1(images, args)  # a CPU tensor takes the plain version
    assert torch.equal(out, s2d_stem.fused_stem_block1_reference(images, args))
    return out.float().numpy()


@pytest.mark.parametrize(
    "batch,height,width,row_tile", [(4, 32, 32, 4), (8, 48, 64, 4), (4, 64, 32, 8)]
)
def test_plain_version_matches_pallas_kernel_and_six_convs(batch, height, width, row_tile):
    rng = np.random.default_rng(height + width)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
    got = _port(folded, x)
    assert got.shape == (batch, height // 4, width // 4, 24)
    kernel = fused_s2d_stem_block1(jnp.asarray(x), folded, row_tile=row_tile, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=F32_TOL, atol=F32_TOL)
    convs = jax_six_convs(folded, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(convs), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("batch,height,width", [(3, 36, 52), (1, 4, 4), (2, 8, 100)])
def test_plain_version_at_shapes_the_packed_kernel_refuses(batch, height, width):
    """Any batch and any multiple of 4: the JAX kernel wants batches of four
    and whole row tiles, so the six-conv path is the reference here."""
    rng = np.random.default_rng(batch + height)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
    want = np.asarray(jax_six_convs(folded, jnp.asarray(x)))
    np.testing.assert_allclose(_port(folded, x), want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_version_bf16():
    """bf16 like serving.  The JAX package's bar: the deviation from the f32
    result must not exceed the six-conv bf16 path's own.  And the plain
    version rounds where the Pallas kernel rounds, so the two stay within two
    bf16 ulps of each other."""
    rng = np.random.default_rng(0)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (4, 96, 128, 3)).astype(np.float32)
    want_f32 = np.asarray(jax_six_convs(folded, jnp.asarray(x)))
    got = _port(folded, x, torch.bfloat16)
    folded_bf = {k: (jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
                 for k, (a, b) in folded.items()}
    convs_bf = np.asarray(jax_six_convs(folded_bf, jnp.asarray(x, jnp.bfloat16)), np.float32)
    scale = np.maximum(np.abs(want_f32), 1.0)
    err_port = np.abs(got - want_f32) / scale
    err_convs = np.abs(convs_bf - want_f32) / scale
    assert err_port.mean() <= err_convs.mean() * 1.2
    assert np.quantile(err_port, 0.999) <= max(np.quantile(err_convs, 0.999) * 1.5, 0.05)

    kernel = np.asarray(
        fused_s2d_stem_block1(jnp.asarray(x, jnp.bfloat16), folded, row_tile=4,
                              interpret=True), np.float32)
    np.testing.assert_allclose(got, kernel, rtol=BF16_ULPS, atol=BF16_ULPS)


def test_intermediates_outside_the_image_are_zero_not_relu6_of_the_bias():
    """With large positive biases relu6(bias) = 6 everywhere: a halo of 6s
    instead of 0s would change every border output."""
    rng = np.random.default_rng(1)
    folded = make_stem_folded(rng)
    folded = {name: (k, np.abs(b) + 3.0 if "project" not in name else b)
              for name, (k, b) in folded.items()}
    x = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jax_six_convs(folded, jnp.asarray(x)))
    np.testing.assert_allclose(_port(folded, x), want, rtol=F32_TOL, atol=F32_TOL)


def test_stem_block1_args_layouts():
    folded = make_stem_folded(np.random.default_rng(2))
    args = s2d_stem.stem_block1_args(port_folded(folded))
    assert [tuple(a.shape) for a in args] == [
        (27, 32), (32,), (9, 32), (32,), (32, 16), (16,),
        (16, 96), (96,), (9, 96), (96,), (96, 24), (24,)]
    assert all(a.is_contiguous() for a in args)
    # rows ordered (dy, dx, cin), columns the output channels: HWIO flattened
    np.testing.assert_array_equal(
        args[0].numpy(), folded["backbone-block0-expand"][0].reshape(27, 32))
    np.testing.assert_array_equal(
        args[8].numpy(), folded["backbone-block1-depthwise"][0].reshape(9, 96))


def test_wrapper_rejects_what_the_kernel_cannot_take():
    args = s2d_stem.stem_block1_args(port_folded(make_stem_folded(np.random.default_rng(3))))
    ok = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="multiples of 4"):
        s2d_stem.fused_stem_block1(torch.zeros(2, 10, 8, 3), args)
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        s2d_stem.fused_stem_block1(torch.zeros(2, 8, 8, 4), args)
    with pytest.raises(ValueError, match="not supported"):
        s2d_stem.fused_stem_block1(ok.half(), args)
    with pytest.raises(ValueError, match="contiguous"):
        s2d_stem.fused_stem_block1(torch.zeros(2, 3, 8, 8).permute(0, 2, 3, 1), args)
    with pytest.raises(ValueError, match="bfloat16"):
        s2d_stem.fused_stem_block1(ok.bfloat16(), args)  # weights in another dtype
    with pytest.raises(ValueError, match="12 tensors"):
        s2d_stem.fused_stem_block1(ok, args[:10])
    with pytest.raises(ValueError, match="expected"):
        s2d_stem.fused_stem_block1(ok, args[:-1] + (torch.zeros(25),))


def test_s2d_stem_value_validation():
    """Typos fail loudly, the unported conv reformulation says where it is
    queued, and a shape the gate refuses takes the plain stem."""
    x = torch.zeros(1, 3, 8, 8)
    for bad in ("palas", "pallas", True):
        with pytest.raises(ValueError, match="s2d_stem"):
            port_fused.mobilenetv2_features_fused({}, x, s2d_stem=bad)
    with pytest.raises(NotImplementedError, match="Queue 1 #15"):
        port_fused.mobilenetv2_features_fused({}, x, s2d_stem="xla")
    assert port_fused._s2d_stem_applicable(torch.zeros(3, 3, 36, 52))
    assert not port_fused._s2d_stem_applicable(torch.zeros(4, 3, 482, 640))
    assert not port_fused._s2d_stem_applicable(torch.zeros(4, 3, 480, 642))
