"""The port's fused depthwise 3x3 backward on the CPU, where its wrapper runs
the plain version: against the JAX package's Pallas kernel in interpret mode,
against torch.autograd of the plain convolution, and through the model's
gate.  The CUDA kernel itself is held against the same plain version on the
card by chip_smoke.py.

Tolerances: f32 rtol 2e-4 / atol 2e-5 (the JAX test's,
tests/test_depthwise_backward.py); dk is a sum over B*H*W terms and is
scaled by its largest reference magnitude.  bf16 inputs: all arithmetic is
f32 in both, dx is rounded once (2 bf16 ulps, 1.6e-2).

The kernel's decomposition -- persistent CTAs, each walking every G-th tile
of one chunk of channels, x and dy staged with a one-pixel halo of zeros, dk
summed over each CTA's tiles and the CTAs' partials summed by `finish` in
groups of ceil(sqrt(G)) -- is emulated in plain PyTorch
(`_emulate_kernel`) with the tile and chunk read from the source, and held
against the plain version (dk within 1e-6 of its largest magnitude) and the
Pallas kernel.  G comes from the card's occupancy, so several are tried.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_tpu.ops import depthwise_backward as tpu_dwb
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.blocks import DepthwiseConvBN, SepConvBN
from ssdseglib_torch.ops import depthwise_backward as dwb
from tests.torch_parity import (  # noqa: F401 (two_torch_threads: autouse fixture)
    source_constants,
    ticket_sum,
    two_torch_threads,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(2, 16, 24, 8), (1, 8, 40, 5), (3, 16, 8, 12)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=shape) * 2.0).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(3, 3, 1, shape[-1])) * 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, dy, kernel = _inputs(sum(shape), shape)
    want_dx, want_dk = tpu_dwb.depthwise3x3_backward(
        jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jnp.asarray(kernel, jdt), interpret=True)
    before = dwb.depthwise3x3_backward.launches
    dx, dk = dwb.depthwise3x3_backward(
        torch.tensor(x).to(tdt), torch.tensor(dy).to(tdt), torch.tensor(kernel).to(tdt))
    assert dwb.depthwise3x3_backward.launches == before  # a CPU tensor never launches
    assert dx.dtype == tdt and dx.shape == tuple(shape)
    assert dk.dtype == torch.float32 and dk.shape == (3, 3, 1, shape[-1])
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want_dx, np.float32), **tol)
    want_dk = np.asarray(want_dk, np.float32)
    scale = max(1.0, float(np.abs(want_dk).max()))
    np.testing.assert_allclose(dk.numpy() / scale, want_dk / scale, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_unit_forward_bit_identical_and_grads_match(dtype):
    _, tdt = DTYPES[dtype]
    shape = (2, 16, 24, 8)
    x, dy, kernel = _inputs(5, shape)
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).to(tdt)
    xt = nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    weight = torch.tensor(kernel).permute(3, 2, 0, 1).to(tdt).requires_grad_()
    dyt = nchw(dy).contiguous(memory_format=torch.channels_last)

    y = dwb.depthwise_conv3x3_fused_bwd(xt, weight)
    y_ref = F.conv2d(xt, weight, None, 1, 1, 1, shape[-1])
    assert torch.equal(y, y_ref)
    copies = dwb.depthwise_conv3x3_fused_bwd.copies
    got = torch.autograd.grad(y, (xt, weight), dyt)
    assert dwb.depthwise_conv3x3_fused_bwd.copies == copies  # zero-copy NHWC views
    want = torch.autograd.grad(y_ref, (xt, weight), dyt)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for g, w, name in zip(got, want, ("dx", "dk")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = max(1.0, float(w.float().abs().max())) if name == "dk" else 1.0
        np.testing.assert_allclose(g.float().numpy() / scale, w.float().numpy() / scale,
                                   err_msg=name, **tol)
    # an input that is not channels-last is copied, and the copy is counted
    plain = nchw(x).contiguous().requires_grad_()
    torch.autograd.grad(dwb.depthwise_conv3x3_fused_bwd(plain, weight), plain, dyt)
    assert dwb.depthwise_conv3x3_fused_bwd.copies == copies + 1


def test_plain_version_taps_are_not_transposed():
    """One non-zero tap at (i, j) = (0, 2) and one non-zero cotangent: dx
    lands at (t + 1 - i, w + 1 - j) and only dk[i', j'] with x under it is
    non-zero."""
    x = torch.zeros(1, 5, 7, 1)
    dy = torch.zeros(1, 5, 7, 1)
    kernel = torch.zeros(3, 3, 1, 1)
    kernel[0, 2] = 2.0
    dy[0, 2, 3] = 1.0
    x[0, 1, 4] = 3.0  # = (t + i - 1, w + j - 1) for (t, w) = (2, 3), (i, j) = (0, 2)
    dx, dk = dwb.depthwise3x3_backward(x, dy, kernel)
    want_dx = torch.zeros_like(x)
    want_dx[0, 1, 4] = 2.0  # y[t, w] reads x[t + i - 1, w + j - 1]
    assert torch.equal(dx, want_dx)
    want_dk = torch.zeros_like(kernel)
    want_dk[0, 2] = 3.0
    assert torch.equal(dk, want_dk)


@pytest.fixture
def gates():
    yield blocks
    blocks.set_chain_bwd_impl("aten")
    blocks.set_depthwise_bwd_impl("aten")


@pytest.mark.parametrize("kind", ["DepthwiseConvBN", "SepConvBN"])
def test_module_route_matches_default_route(gates, kind):
    """The depthwise gate on an in-envelope shape: same state_dict keys,
    bit-identical forward and running statistics (the forward IS the plain
    conv), close gradients (rtol 5e-3 / atol 5e-4 of each tensor's largest), through
    the fused unit."""
    b, h, w, c = 1, 128, 256, 32
    assert dwb.pallas_bwd_applicable(h, w, c, (3, 3), (1, 1), (1, 1))
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(b, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2)
    module = (DepthwiseConvBN(c, strides=1, relu_max=6.0) if kind == "DepthwiseConvBN"
              else SepConvBN(c, 16, 3, relu_max=6.0))
    blocks.init_weights(module, torch.Generator().manual_seed(3))
    start = {k: v.clone() for k, v in module.state_dict().items()}

    def run(impl):
        gates.set_depthwise_bwd_impl(impl)
        module.load_state_dict(start)
        module.train()
        xin = x.clone().requires_grad_()
        y = module(xin)
        grads = torch.autograd.grad((y * y).sum(), [xin, *module.parameters()])
        return y.detach(), grads, {k: v.clone() for k, v in module.state_dict().items()}

    y_plain, g_plain, s_plain = run("aten")
    before = dwb.depthwise_conv3x3_fused_bwd.copies
    calls = []
    original = dwb.depthwise3x3_backward

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return original(*args)

    dwb.depthwise3x3_backward = spy
    try:
        y_fused, g_fused, s_fused = run("cuda")
    finally:
        dwb.depthwise3x3_backward = original
    assert calls == [(b, h, w, c)]
    assert dwb.depthwise_conv3x3_fused_bwd.copies >= before
    assert torch.equal(y_fused, y_plain)
    assert set(s_fused) == set(s_plain)
    for k in s_plain:
        assert torch.equal(s_fused[k], s_plain[k]), k
    for a, bb in zip(g_fused, g_plain):  # sums over 32768 pixels: per tensor scale
        scale = max(1.0, float(bb.abs().max()))
        np.testing.assert_allclose(a.numpy() / scale, bb.numpy() / scale, rtol=5e-3,
                                   atol=5e-4)


def test_envelope_and_rejections(gates):
    ok = ((3, 3), (1, 1), (1, 1))
    assert dwb.pallas_bwd_applicable(240, 320, 32, *ok)
    assert not dwb.pallas_bwd_applicable(120, 160, 144, *ok)  # C > 64
    assert not dwb.pallas_bwd_applicable(240, 320, 32, (3, 3), (2, 2), (1, 1))
    assert not dwb.pallas_bwd_applicable(240, 320, 32, (3, 3), (1, 1), (2, 2))
    assert not dwb.pallas_bwd_applicable(8, 8, 8, *ok)
    for args in ((240, 320, 32), (120, 160, 144), (8, 8, 8), (128, 256, 32)):
        assert dwb.pallas_bwd_applicable(*args, *ok) == tpu_dwb.pallas_bwd_applicable(*args, *ok)
    x, dy, kernel = (torch.tensor(a) for a in _inputs(1, (1, 4, 6, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        dwb.depthwise3x3_backward(x, dy.transpose(1, 2).contiguous().transpose(1, 2), kernel)
    with pytest.raises(ValueError, match="differ"):
        dwb.depthwise3x3_backward(x, dy[:, :3], kernel)
    with pytest.raises(ValueError, match="kernel has shape"):
        dwb.depthwise3x3_backward(x, dy, kernel.reshape(9, 3))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        dwb.depthwise3x3_backward(x[0], dy[0], kernel)
    with pytest.raises(ValueError, match="weight has shape"):
        dwb.depthwise_conv3x3_fused_bwd(x.permute(0, 3, 1, 2), torch.zeros(3, 1, 5, 5))


def _emulate_kernel(x, dy, kernel, ctas):
    """The launch's order of work on NHWC CPU tensors with ``ctas`` CTAs a
    channel chunk: (dx, dk (3, 3, 1, C)).  dx of a tile is three tap-row sums
    added as (row above + centre row) + row below, as the kernel adds them."""
    k = source_constants("depthwise_backward.cu", "kChunk", "kTileRows", "kTileCols")
    tr, tw = k["kTileRows"], k["kTileCols"]
    batch, h, w, c = x.shape
    vector = 16 // x.element_size()  # channels of a 16-byte copy
    cc = 1 << (min(c, k["kChunk"]) - 1).bit_length()
    if c % vector == 0:
        cc = max(cc, vector)
    taps = kernel.float().reshape(3, 3, c)
    # zeros outside the image: the halo's, and the ragged tiles' past the edge
    g_p = F.pad(dy.float(), (0, 0, 1, tw + 1, 1, tr + 1))
    x_p = F.pad(x.float(), (0, 0, 1, tw + 1, 1, tr + 1))
    dx = torch.zeros(x.shape, dtype=torch.float32)
    dk = torch.zeros(9, c)
    for c0 in range(0, c, cc):
        ch = slice(c0, min(c0 + cc, c))
        tile_partials = []
        for b in range(batch):  # tiles in the kernel's order: image, tile row, tile column
            for y0 in range(0, h, tr):
                for x0 in range(0, w, tw):
                    g = g_p[b, y0:y0 + tr + 2, x0:x0 + tw + 2, ch]
                    xs = x_p[b, y0:y0 + tr + 2, x0:x0 + tw + 2, ch]
                    rows = []
                    for i in range(3):  # tap row i reads dy one row below for i = 0
                        s = torch.zeros((tr, tw, g.shape[-1]))
                        for j in range(3):
                            s = s + taps[i, j, ch] * g[2 - i:2 - i + tr, 2 - j:2 - j + tw]
                        rows.append(s)
                    out = (rows[0] + rows[1]) + rows[2]
                    rows_, cols = min(tr, h - y0), min(tw, w - x0)
                    dx[b, y0:y0 + rows_, x0:x0 + cols, ch] = out[:rows_, :cols]
                    tile_partials.append(torch.stack([
                        (xs[i:i + tr, j:j + tw] * g[1:1 + tr, 1:1 + tw]).sum((0, 1))
                        for i in range(3) for j in range(3)]))
        walkers = min(ctas, len(tile_partials))  # CTA i takes tiles i, i + walkers, ...
        cta_partials = []
        for i in range(walkers):
            s = torch.zeros_like(tile_partials[0])
            for t in range(i, len(tile_partials), walkers):
                s = s + tile_partials[t]
            cta_partials.append(s)
        dk[:, ch] = ticket_sum(torch.stack(cta_partials))
    return dx.to(x.dtype), dk.reshape(3, 3, 1, c)


# the shapes above (C = 8, 5, 12: the 16-byte path, and the scalar path of a C
# that is not a multiple of the vector), and one with two channel chunks;
# every one has ragged tiles
EMULATED_SHAPES = SHAPES + [(1, 20, 18, 40)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_kernel_decomposition_matches_plain_version_and_pallas(shape, dtype):
    """dk within 1e-6 of the plain version's largest magnitude, dx within the
    module's tolerances; against the Pallas kernel the module's tolerances;
    for one CTA a chunk, three, and more CTAs than tiles."""
    jdt, tdt = DTYPES[dtype]
    x, dy, kernel = _inputs(sum(shape) + 2, shape)
    want_dx, want_dk = tpu_dwb.depthwise3x3_backward(
        jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jnp.asarray(kernel, jdt), interpret=True)
    want_dx, want_dk = np.asarray(want_dx, np.float32), np.asarray(want_dk, np.float32)
    xt, dyt, kt = (torch.tensor(a).to(tdt) for a in (x, dy, kernel))
    plain_dx, plain_dk = dwb.depthwise3x3_backward_reference(xt, dyt, kt)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    for ctas in (1, 3, 264):
        dx, dk = _emulate_kernel(xt, dyt, kt, ctas)
        assert dx.dtype == tdt and dx.shape == tuple(shape)
        np.testing.assert_allclose(dx.float().numpy(), plain_dx.float().numpy(), **tol)
        np.testing.assert_allclose(dx.float().numpy(), want_dx, **tol)
        scale = max(1.0, float(plain_dk.abs().max()))
        assert float((dk - plain_dk).abs().max()) <= 1e-6 * scale, ctas
        scale = max(1.0, float(np.abs(want_dk).max()))
        np.testing.assert_allclose(dk.numpy() / scale, want_dk / scale, rtol=2e-4, atol=2e-5)
