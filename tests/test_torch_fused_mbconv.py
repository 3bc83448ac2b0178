"""The fused MBConv wrapper's plain twin (what it runs on a CPU tensor)
against the JAX Pallas kernel in interpret mode, at the five (Cin, E, Cout)
widths of the 480x640 serving path and reduced spatial sizes.  The CUDA
kernel itself is held against the same twin on the card by chip_smoke.py.

The bf16 kernel's decomposition -- spatial tiles with a one-pixel halo, E
walked in chunks of EC channels, the project summed over the chunks, ragged
edge tiles -- is emulated here in plain PyTorch (`_emulate_decomposition`)
and held against the twin and the Pallas kernel, in f32 at 1e-5, at the
(th, tw, EC) the source picks for each width and at shapes whose halo
crosses every image border.  The twin that sums in the kernel's
tensor-core order (``k_groups=True``) is held against the plain twin."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.ops import fused_mbconv as tpu_ops
from ssdseglib_torch.ops.fused_mbconv import (
    fold_conv_bn,
    fused_mbconv,
    fused_mbconv_reference,
)

# (Cin, E, Cout) of blocks 2, 4-5, 7-9, 11-12, 14-15 at 480x640
SLICE_WIDTHS = [(24, 144, 24), (32, 192, 32), (64, 384, 64), (96, 576, 96),
                (160, 960, 160)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          # 2 bf16 ulps of the reference value
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _block(seed, cin, e, cout, h, w):
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = draw(2, h, w, cin)
    weights = (draw(cin, e, scale=cin ** -0.5), draw(e, scale=0.1),
               draw(3, 3, 1, e, scale=1 / 3), draw(e, scale=0.1),
               draw(e, cout, scale=e ** -0.5), draw(cout, scale=0.1))
    return x, weights


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw,residual", [((12, 16), True), ((15, 20), True),
                                         ((12, 16), False)])
@pytest.mark.parametrize("cin,e,cout", SLICE_WIDTHS)
def test_twin_matches_pallas_kernel(cin, e, cout, hw, residual, dtype):
    _, jdt, tdt, tol = DTYPES[dtype]
    x, weights = _block(cin + e, cin, e, cout, *hw)
    expected = tpu_ops.fused_mbconv(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in weights),
        residual=residual, interpret=True,
    )
    # the wrapper takes weights already cast to x's dtype, as the JAX
    # wrapper casts them (fused_mbconv.py:164-166)
    before = fused_mbconv.launches
    got = fused_mbconv(
        torch.from_numpy(x).to(tdt),
        *(torch.from_numpy(a).to(tdt) for a in weights),
        residual=residual,
    )
    assert fused_mbconv.launches == before  # a CPU tensor never launches
    assert got.dtype == tdt and tuple(got.shape) == (2,) + hw + (cout,)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(expected.astype(jnp.float32)),
        rtol=tol, atol=tol,
    )


def test_fold_conv_bn_equals_jax():
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)  # HWIO
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.normal(size=16).astype(np.float32)
    mean = rng.normal(size=16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    k_jax, b_jax = tpu_ops.fold_conv_bn(kernel, gamma, beta, mean, var)
    k_port, b_port = fold_conv_bn(kernel.transpose(3, 2, 0, 1), gamma, beta, mean, var)
    np.testing.assert_array_equal(k_port, k_jax.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(b_port, b_jax)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    x, weights = _block(0, 16, 32, 8, 4, 5)
    xt = torch.from_numpy(x)
    wt = [torch.from_numpy(a) for a in weights]
    with pytest.raises(ValueError, match="residual"):
        fused_mbconv(xt, *wt, residual=True)  # Cin 16 != Cout 8
    with pytest.raises(ValueError, match="dtype"):
        fused_mbconv(xt.double(), *(w.double() for w in wt), residual=False)
    with pytest.raises(ValueError, match="x is"):
        fused_mbconv(xt, *wt[:5], wt[5].to(torch.bfloat16), residual=False)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mbconv(xt.transpose(1, 2), *wt, residual=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mbconv(xt.to("meta"), *(w.to("meta") for w in wt), residual=False)
    # the twin takes the JAX layouts as well: (1,1,Cin,E) / (3,3,1,E)
    got = fused_mbconv(xt, wt[0][None, None], wt[1], wt[2], wt[3], wt[4], wt[5],
                       residual=False)
    ref = fused_mbconv_reference(xt, wt[0], wt[1], wt[2].reshape(9, -1), wt[3],
                                 wt[4], wt[5], residual=False)
    assert torch.equal(got, ref)


def _emulate_decomposition(x, w1, b1, wd, b2, w3, b3, residual, th, tw, ec):
    """The bf16 kernel's order of work, in plain PyTorch on NHWC x: per image
    and th x tw tile, x on the tile + 1-px halo (0 outside the image); per
    chunk of ``ec`` expanded channels, the expand (0 outside the image, where
    the depthwise conv's padding is), the 3x3 taps in row-major order, and
    the project partial added to an f32 accumulator; then the bias, the
    rounding and the residual.  Ragged edge tiles are cut at the image."""
    dt, f32 = x.dtype, torch.float32
    batch, h, w, cin = x.shape
    e, cout = w1.shape[1], w3.shape[1]
    assert e % ec == 0
    taps = wd.reshape(9, e).to(f32)
    out = torch.empty((batch, h, w, cout), dtype=dt)
    padded = torch.nn.functional.pad(x, (0, 0, 1, tw + 1, 1, th + 1))  # room for ragged tiles
    inside = torch.zeros((h + th + 2, w + tw + 2), dtype=torch.bool)
    inside[1:h + 1, 1:w + 1] = True
    for b in range(batch):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                halo = padded[b, y0:y0 + th + 2, x0:x0 + tw + 2].to(f32)
                keep = inside[y0:y0 + th + 2, x0:x0 + tw + 2, None]
                acc = torch.zeros((th * tw, cout), dtype=f32)
                for c0 in range(0, e, ec):
                    chunk = slice(c0, c0 + ec)
                    ex = halo.reshape(-1, cin) @ w1[:, chunk].to(f32) + b1[chunk].to(f32)
                    ex = ex.to(dt).clamp(0.0, 6.0).reshape(th + 2, tw + 2, ec)
                    ex = torch.where(keep, ex, torch.zeros((), dtype=dt)).to(f32)
                    d = torch.zeros((th, tw, ec), dtype=f32)
                    for dy in range(3):
                        for dx in range(3):
                            d = d + ex[dy:dy + th, dx:dx + tw] * taps[dy * 3 + dx, chunk]
                    d = (d + b2[chunk].to(f32)).to(dt).clamp(0.0, 6.0)
                    acc = acc + d.reshape(-1, ec).to(f32) @ w3[chunk].to(f32)
                y = (acc + b3.to(f32)).to(dt).reshape(th, tw, cout)
                if residual:
                    y = y + halo[1:th + 1, 1:tw + 1].to(dt)
                rows, cols = min(th, h - y0), min(tw, w - x0)
                out[b, y0:y0 + rows, x0:x0 + cols] = y[:rows, :cols]
    return out


def _source_configs():
    """{(Cin, E): (th, tw, EC, NREP)}: the bf16 kernel's per-width choice,
    read from its source (csrc/fused_mbconv.cu, `bf16_config`)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ssdseglib_torch", "csrc", "fused_mbconv.cu")
    with open(path) as f:
        source = f.read()
    found = re.findall(r"if \(Cin == (\d+) && E == (\d+)\) return \{(\d+), (\d+), (\d+), (\d+)\};",
                       source)
    return {(int(c), int(e)): tuple(int(v) for v in rest) for c, e, *rest in found}


def test_source_configs_cover_the_serving_widths_and_fit_the_kernel():
    """Every serving width has a chosen (th, tw, EC, NREP); EC is a multiple
    of the mma depth that divides E, and the warps (16-row tiles of the
    output tile times Cout's 8-channel tiles over NREP) stay within 16."""
    configs = _source_configs()
    assert set(configs) == {(cin, e) for cin, e, _ in SLICE_WIDTHS}
    for (cin, e), (th, tw, ec, nrep) in configs.items():
        assert ec % 16 == 0 and e % ec == 0, (cin, e, ec)
        m_tiles = -(-(th * tw) // 16)
        assert nrep in (1, 2, 3, 4, 5, 6, 8, 10)
        assert m_tiles * -(-(cin // 8) // nrep) <= 16, (cin, e, th, tw, nrep)


# (Cin, E, Cout, (H, W), (th, tw, EC), residual): the source's tile and chunk
# at each width on a small image whose edge tiles are ragged, then shapes
# whose halo crosses every image border (a tile larger than the image) and
# where E / EC is large
DECOMPOSITIONS = [(cin, e, cin, (13, 11), cfg[:3], residual)
                  for (cin, e), cfg in sorted(_source_configs().items())
                  for residual in (True, False)] + [
    (24, 144, 24, (5, 7), (8, 16, 48), True),
    (24, 144, 24, (5, 7), (8, 16, 48), False),
    (32, 96, 32, (4, 3), (6, 8, 16), True),
    (16, 96, 8, (9, 10), (4, 4, 16), False),
]


@pytest.mark.parametrize(
    "cin,e,cout,hw,tile,residual", DECOMPOSITIONS,
    ids=[f"{d[0]}-{d[1]}-{d[3][0]}x{d[3][1]}-t{d[4]}-{'res' if d[5] else 'nores'}"
         for d in DECOMPOSITIONS])
def test_kernel_decomposition_matches_twin_and_pallas(cin, e, cout, hw, tile, residual):
    x, weights = _block(cin * 7 + e, cin, e, cout, *hw)
    xt = torch.from_numpy(x)
    wt = [torch.from_numpy(a) for a in weights]
    w1, b1, wd, b2, w3, b3 = wt[0], wt[1], wt[2].reshape(9, e), wt[3], wt[4], wt[5]
    got = _emulate_decomposition(xt, w1, b1, wd, b2, w3, b3, residual, *tile)
    twin = fused_mbconv_reference(xt, w1, b1, wd, b2, w3, b3, residual)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5, atol=1e-5)
    pallas = tpu_ops.fused_mbconv(jnp.asarray(x), *(jnp.asarray(a) for a in weights),
                                  residual=residual, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,e,tile", [(24, 144, (8, 16, 48)), (64, 384, (3, 5, 48))])
def test_kernel_decomposition_in_bf16_within_two_ulps_of_twin(cin, e, tile):
    """The same decomposition with the bf16 roundings: within the kernel's
    own tolerance (2 bf16 ulps) of the twin; the sums are taken in another
    order, so a rounding may fall on the other side."""
    x, weights = _block(cin + 3 * e, cin, e, cin, 9, 13)
    xt = torch.from_numpy(x).bfloat16()
    wt = [torch.from_numpy(a).bfloat16() for a in weights]
    w1, b1, wd, b2, w3, b3 = wt[0], wt[1], wt[2].reshape(9, e), wt[3], wt[4], wt[5]
    got = _emulate_decomposition(xt, w1, b1, wd, b2, w3, b3, True, *tile)
    twin = fused_mbconv_reference(xt, w1, b1, wd, b2, w3, b3, True)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(), rtol=1.6e-2,
                               atol=1.6e-2)


@pytest.mark.parametrize("cin,e", [(24, 144), (64, 384)])
def test_k_group_twin_within_two_ulps_of_the_plain_twin(cin, e):
    """The twin in the bf16 kernel's tensor-core order (16-deep mma steps
    into the running accumulator) against the plain twin: within the
    kernel's bf16 tolerance (2 ulps of the value), and in f32 within 1e-5;
    the order changes roundings, not the function."""
    x, weights = _block(cin * 5 + e, cin, e, cin, 9, 13)
    for dtype, tol in ((torch.bfloat16, 1.6e-2), (torch.float32, 1e-5)):
        xt = torch.from_numpy(x).to(dtype)
        wt = [torch.from_numpy(a).to(dtype) for a in weights]
        got = fused_mbconv_reference(xt, *wt, residual=True, k_groups=True)
        want = fused_mbconv_reference(xt, *wt, residual=True)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol,
                                   atol=tol)
