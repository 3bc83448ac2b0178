"""The plain version of the port's fused stem + block 1 kernel against the
JAX package on the same folded convs and images: the Pallas kernel in
interpret mode and the six-conv composition, f32 and bf16.

The bf16 kernel's decomposition -- output tiles with their halos, block 1's
96 channels in chunks, the project's partials summed chunk by chunk, ragged
edge tiles -- is emulated here in plain PyTorch (`_emulate_decomposition`)
at the tile and chunk the source picks, and held against the plain version
and the Pallas kernel; so is the plain version that sums in the kernel's
tensor-core order (``k_groups=True``).

The JAX package's second study, the packed conv reformulation
(``s2d_stem="xla"``): the weight packers bit for bit, `s2d_stem_block1_xla`
against the JAX function, and the backbone through it against the JAX
package's."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_tpu.models import fused_inference as tpu_fused
from ssdseglib_tpu.models.fused_inference import _conv
from ssdseglib_tpu.ops import s2d_stem as tpu_s2d
from ssdseglib_tpu.ops.s2d_stem import fused_s2d_stem_block1
from ssdseglib_torch.models import fused_inference as port_fused
from ssdseglib_torch.ops import s2d_stem
from tests.torch_parity import (  # noqa: F401
    bf16_ulps,
    make_stem_folded,
    port_folded,
    port_model_and_jax_variables,
    two_torch_threads,
)

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


def test_s2d_stem_value_validation(backbone):
    """Typos fail loudly, the conv reformulation gives the kernel route's
    plain version's taps, and a shape the gate refuses takes the plain
    stem: for "xla" a batch that is not a multiple of PACK as well."""
    x = torch.zeros(1, 3, 8, 8)
    for bad in ("palas", "pallas", True):
        with pytest.raises(ValueError, match="s2d_stem"):
            port_fused.mobilenetv2_features_fused({}, x, s2d_stem=bad)
    operands, _, images = backbone
    xla = port_fused.mobilenetv2_features_fused(operands, images, s2d_stem="xla")
    cuda = port_fused.mobilenetv2_features_fused(operands, images, s2d_stem="cuda")
    for got, want in zip(xla, cuda):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert port_fused._s2d_stem_applicable(torch.zeros(3, 3, 36, 52))
    assert not port_fused._s2d_stem_applicable(torch.zeros(4, 3, 482, 640))
    assert not port_fused._s2d_stem_applicable(torch.zeros(4, 3, 480, 642))
    assert port_fused._s2d_stem_applicable(torch.zeros(4, 3, 36, 52), "xla")
    assert not port_fused._s2d_stem_applicable(torch.zeros(3, 3, 36, 52), "xla")


def _source_config():
    """(tile rows, tile columns, chunk) of the bf16 kernel's built-in choice,
    read from its source (csrc/s2d_stem.cu, `kStemConfig`)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ssdseglib_torch", "csrc", "s2d_stem.cu")
    with open(path) as f:
        found = re.findall(
            r"constexpr StemConfig kStemConfig = \{(\d+), (\d+), (\d+), (\d+)\};",
            f.read())
    assert len(found) == 1, found
    return tuple(int(v) for v in found[0][:3])


def _emulate_decomposition(images, folded, to, tw, ec, k_groups=False):
    """The bf16 kernel's order of work, in plain PyTorch on NHWC images: per
    image and to x tw output tile at H/4, the image on the tile's halo (0
    outside the image); e on (2 to + 3) x (2 tw + 3) pixels, d, p on
    (2 to + 1) x (2 tw + 1), each intermediate 0 outside the image where it
    is the next conv's padding; then per chunk of ``ec`` of block 1's
    channels the expand, the stride-2 depthwise and the project's partial,
    added to an f32 sum (each 16-deep step on its own with ``k_groups``);
    then the bias and the rounding.  Ragged edge tiles are cut at the map."""
    w1, b1, wd1, bd1, wp1, bp1, w2, b2, wd2, bd2, wp2, bp2 = folded
    dt, f32 = images.dtype, torch.float32
    batch, h, w, _ = images.shape
    h2, w2dim, h4, w4 = h // 2, w // 2, h // 4, w // 4

    def accumulate(acc, x, weight):
        x2 = x.reshape(-1, x.shape[-1]).float()
        if not k_groups:
            return acc + x2 @ weight.float()
        for k0 in range(0, x2.shape[1], 16):
            acc = acc + s2d_stem.tensor_core_step(x2[:, k0:k0 + 16], weight[k0:k0 + 16])
        return acc

    def product(x, weight, bias):
        zeros = torch.zeros((x[..., 0].numel(), weight.shape[1]), dtype=f32)
        y = accumulate(zeros, x, weight) + bias.float()
        return y.reshape(*x.shape[:-1], -1)

    def relu6(v):
        return v.to(dt).clamp(0.0, 6.0)

    def depthwise(x, taps, bias, oh, ow, stride):
        acc = torch.zeros((oh, ow, x.shape[-1]), dtype=f32)
        for dy in range(3):
            for dx in range(3):
                window = x[dy:dy + stride * oh:stride, dx:dx + stride * ow:stride].float()
                acc = acc + window * taps[dy * 3 + dx].float()
        return relu6(acc + bias.float())

    def inside(rows, cols, top, left, limit_h, limit_w):
        r = torch.arange(rows)[:, None] + top
        c = torch.arange(cols)[None, :] + left
        return ((r >= 0) & (r < limit_h) & (c >= 0) & (c < limit_w))[..., None]

    zero = torch.zeros((), dtype=dt)
    out = torch.zeros((batch, h4, w4, 24), dtype=dt)
    padded = F.pad(images, (0, 0, 2, 4 * tw + 8, 2, 4 * to + 8))
    eh, ew, ph, pw = 2 * to + 3, 2 * tw + 3, 2 * to + 1, 2 * tw + 1
    for b in range(batch):
        for oy0 in range(0, h4, to):
            for ox0 in range(0, w4, tw):
                r0, c0 = 2 * oy0, 2 * ox0
                tile = padded[b, 4 * oy0:4 * oy0 + 4 * to + 7, 4 * ox0:4 * ox0 + 4 * tw + 7]
                patches = torch.cat([tile[dy:dy + 2 * eh:2, dx:dx + 2 * ew:2]
                                     for dy in range(3) for dx in range(3)], dim=-1)
                e = relu6(product(patches, w1, b1))
                e = torch.where(inside(eh, ew, r0 - 1, c0 - 1, h2, w2dim), e, zero)
                d = depthwise(e, wd1, bd1, ph, pw, 1)
                p = product(d, wp1, bp1).to(dt)
                keep = inside(ph, pw, r0, c0, h2, w2dim)
                p = torch.where(keep, p, zero)
                acc = torch.zeros((to * tw, 24), dtype=f32)
                for cb in range(0, 96, ec):
                    chunk = slice(cb, cb + ec)
                    e2 = torch.where(keep, relu6(product(p, w2[:, chunk], b2[chunk])), zero)
                    d2 = depthwise(e2, wd2[:, chunk], bd2[chunk], to, tw, 2)
                    acc = accumulate(acc, d2, wp2[chunk])
                y = (acc + bp2.float()).to(dt).reshape(to, tw, 24)
                rows, cols = min(to, h4 - oy0), min(tw, w4 - ox0)
                out[b, oy0:oy0 + rows, ox0:ox0 + cols] = y[:rows, :cols]
    return out


def test_source_config_fits_the_kernel():
    """The built-in chunk is a multiple of the mma depth that divides 96."""
    to, tw, ec = _source_config()
    assert to >= 1 and tw >= 1 and ec % 16 == 0 and 96 % ec == 0


# (B, H, W, (tile rows, tile columns, chunk)): the source's choice where one
# tile crosses every border of the image (H/4 x W/4 = 4 x 6), and where H/4
# and W/4 (12 x 18) are not multiples of the tile; then other tiles and
# chunks on the second image
DECOMPOSITIONS = [(4, 16, 24, _source_config()), (4, 48, 72, _source_config()),
                  (4, 48, 72, (4, 8, 16)), (4, 48, 72, (5, 7, 32)), (4, 48, 72, (3, 20, 96))]


@pytest.mark.parametrize("batch,height,width,tile", DECOMPOSITIONS,
                         ids=[f"{d[1]}x{d[2]}-t{d[3]}" for d in DECOMPOSITIONS])
def test_kernel_decomposition_matches_plain_version_and_pallas(batch, height, width, tile):
    rng = np.random.default_rng(height * 7 + width + tile[2])
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
    args = s2d_stem.stem_block1_args(port_folded(folded))
    images = torch.from_numpy(x)
    got = _emulate_decomposition(images, args, *tile).numpy()
    np.testing.assert_allclose(got, s2d_stem.fused_stem_block1_reference(images, args).numpy(),
                               rtol=1e-5, atol=1e-5)
    kernel = fused_s2d_stem_block1(jnp.asarray(x), folded, row_tile=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k_groups", [False, True])
def test_kernel_decomposition_in_bf16_within_two_ulps(k_groups):
    """The same decomposition with the bf16 roundings, at the source's tile:
    within two bf16 ulps of the plain version that sums in the same order
    (``k_groups``: the tensor cores' 16-deep steps), and of the Pallas
    kernel."""
    rng = np.random.default_rng(11)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (4, 48, 72, 3)).astype(np.float32)
    args = s2d_stem.stem_block1_args(port_folded(folded, torch.bfloat16))
    images = torch.from_numpy(x).bfloat16()
    got = _emulate_decomposition(images, args, *_source_config(), k_groups=k_groups)
    twin = s2d_stem.fused_stem_block1_reference(images, args, k_groups=k_groups)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(), rtol=BF16_ULPS,
                               atol=BF16_ULPS)
    kernel = np.asarray(fused_s2d_stem_block1(jnp.asarray(x, jnp.bfloat16), folded, row_tile=4,
                                              interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=BF16_ULPS, atol=BF16_ULPS)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_ULPS)])
def test_k_group_twin_matches_jax_order_twin(dtype, tol):
    """The plain version in the kernel's tensor-core order against the one in
    the JAX package's order, and against the six-conv JAX path (f32)."""
    rng = np.random.default_rng(5)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (2, 36, 52, 3)).astype(np.float32)
    args = s2d_stem.stem_block1_args(port_folded(folded, dtype))
    images = torch.from_numpy(x).to(dtype)
    got = s2d_stem.fused_stem_block1_reference(images, args, k_groups=True).float().numpy()
    want = s2d_stem.fused_stem_block1_reference(images, args).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == torch.float32:
        convs = np.asarray(jax_six_convs(folded, jnp.asarray(x)))
        np.testing.assert_allclose(got, convs, rtol=F32_TOL, atol=F32_TOL)


def test_tensor_core_step_rounds_the_exact_sum_toward_zero():
    """1 + 1.5 * 2^-24 lies between the f32 neighbours 1 and 1 + 2^-23: to
    nearest it rounds up, toward zero down; the sign follows."""
    x = torch.tensor([[1.0, 1.5 * 2.0 ** -24], [-1.0, -1.5 * 2.0 ** -24]]).bfloat16()
    w = torch.ones(2, 1).bfloat16()
    step = s2d_stem.tensor_core_step(x, w)
    assert step.dtype == torch.float32
    assert step[:, 0].tolist() == [1.0, -1.0]
    assert (x.double() @ w.double()).float()[0, 0].item() == 1.0 + 2.0 ** -23


# --- the packed conv reformulation (s2d_stem="xla") --------------------------

@pytest.fixture(scope="module")
def backbone():
    """The port's folded f32 operands of a random SMALL_CFG model with
    ``s2d_stem="xla"`` and ``"cuda"`` (both routes' operands), the JAX
    package's fold of the same weights, and 4 rescaled 48x64 images as a
    channels-last NCHW tensor."""
    model, variables = port_model_and_jax_variables()
    state = model.state_dict()
    operands = port_fused.fused_operands(model.cfg, state,
                                         torch.float32, "cpu", s2d_stem="xla", heads=False)
    operands[port_fused.STEM_OPERANDS["cuda"]] = s2d_stem.stem_block1_args(operands)
    x = np.random.default_rng(8).uniform(-1, 1, (4, 48, 64, 3)).astype(np.float32)
    images = torch.from_numpy(x).permute(0, 3, 1, 2)
    return operands, tpu_fused.fold_mobilenetv2(variables), images


@pytest.mark.parametrize("packer", ["pack_stem_expand", "pack_depthwise", "pack_pointwise"])
def test_packers_equal_the_jax_packers(packer):
    folded = make_stem_folded(np.random.default_rng(12))
    name = {"pack_stem_expand": "backbone-block0-expand",
            "pack_depthwise": "backbone-block1-depthwise",
            "pack_pointwise": "backbone-block1-expand"}[packer]
    got = getattr(s2d_stem, packer)(*folded[name])
    want = getattr(tpu_s2d, packer)(*folded[name])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert s2d_stem.PACK == tpu_s2d.PACK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_stem_block1_xla_matches_jax(dtype):
    """The packed convs against the JAX function on the same folded convs:
    f32 within 1e-5 (and of the port's plain stem), bf16 within two bf16
    ulps.  The ulps are counted, not taken relative to |value|: the two
    sum each conv in another order, so an intermediate may round to its
    other neighbour, which the later convs carry."""
    rng = np.random.default_rng(13)
    folded = make_stem_folded(rng)
    x = rng.uniform(-1, 1, (8, 32, 48, 3)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    packed = [torch.from_numpy(a).to(tdt) for a in s2d_stem.pack_stem_block1(
        {k: (w.numpy(), b.numpy()) for k, (w, b) in port_folded(folded).items()})]
    got = s2d_stem.s2d_stem_block1_xla(torch.from_numpy(x).to(tdt), packed)
    want = np.asarray(tpu_s2d.s2d_stem_block1_xla(jnp.asarray(x, jdt), folded), np.float32)
    assert got.dtype == tdt and tuple(got.shape) == (8, 8, 12, 24)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        plain = _port(folded, x)
        np.testing.assert_allclose(got.numpy(), plain, rtol=1e-5, atol=1e-5)
        return
    ulps = bf16_ulps(got, torch.from_numpy(want).bfloat16())
    assert int(ulps.max()) <= 2 and float((ulps > 0).float().mean()) < 1e-2


def test_backbone_through_the_packed_convs_matches_jax(backbone):
    """`mobilenetv2_features_fused(s2d_stem="xla")` against the JAX
    package's at b4 (its MBConv Pallas kernel in interpret mode), f32: the
    three head taps."""
    operands, jax_folded, images = backbone
    got = port_fused.mobilenetv2_features_fused(operands, images, s2d_stem="xla")
    want = tpu_fused.mobilenetv2_features_fused(
        jax_folded, jnp.asarray(images.permute(0, 2, 3, 1).numpy()), interpret=True,
        s2d_stem="xla")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_a_batch_of_three_takes_the_plain_stem(backbone, monkeypatch):
    operands, _, images = backbone

    def refuse(*args):
        raise AssertionError("the packed convs were called")

    monkeypatch.setattr(port_fused, "s2d_stem_block1_xla", refuse)
    got = port_fused.mobilenetv2_features_fused(operands, images[:3], s2d_stem="xla")
    want = port_fused.mobilenetv2_features_fused(operands, images[:3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(AssertionError, match="packed convs"):
        port_fused.mobilenetv2_features_fused(operands, images, s2d_stem="xla")


def test_tensor_core_step_cuts_terms_at_the_largest_exponent():
    """The H100's step aligns the terms to the largest exponent and cuts
    them 25 bits below its unit bit before the sum: -2^-27 next to 1 is cut
    to 0 and the step gives 1, where the exact sum 1 - 2^-27 rounded toward
    zero gives 1 - 2^-24; a term on the grid (-2^-25) is kept.  A product's
    exponent is the sum of its factors': 1.5 * 1.5 = 2.25 counts as 2^0,
    so -2^-25 beside it is kept too (2.25 - 2^-25 rounds toward zero to
    2.25 - 2^-22).  The accumulator is one of the terms."""
    w = torch.ones(2, 1).bfloat16()
    x = torch.tensor([[1.0, -2.0 ** -27], [1.0, -2.0 ** -25]]).bfloat16()
    step = s2d_stem.tensor_core_step(x, w)
    assert step[:, 0].tolist() == [1.0, 1.0 - 2.0 ** -24]
    acc = torch.tensor([[-2.0 ** -27], [0.0]])
    got = s2d_stem.tensor_core_step(x[:, :1], w[:1], acc)
    assert got[:, 0].tolist() == [1.0, 1.0]
    wide = s2d_stem.tensor_core_step(torch.tensor([[1.5, -2.0 ** -25]]).bfloat16(),
                                     torch.tensor([[1.5], [1.0]]).bfloat16())
    assert wide[0, 0].item() == 2.25 - 2.0 ** -22
