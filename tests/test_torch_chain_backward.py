"""The port's whole-chain backward (dw 3x3 + train-mode BN + ReLU6) on the
CPU, where its wrapper runs the plain version: against the JAX package's
Pallas kernel in interpret mode, against torch.autograd of the plain
composition, and through the model's gate.  The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.

Tolerances.  f32: dx, dk, dgamma, dbeta rtol 2e-4 / atol 2e-5 of the JAX
test (tests/test_chain_backward.py), scaled for dk/dgamma/dbeta by the
largest reference magnitude since they are sums over B*H*W terms.  bf16:
inputs are bf16 in both packages and all arithmetic is f32, so the sums keep
the f32 tolerance; dx is rounded once to bf16 (2 ulps, 1.6e-2).

The kernels' decomposition -- pass 1 over contiguous pixel ranges, pass 2
over tiles with a one-pixel halo and chunks of channels, each pass-2 CTA
summing dk over the tiles it walks (every G-th of its chunk), each pass's
per-CTA partials summed in groups of ceil(sqrt(CTAs)) in CTA order and the
groups in group order -- is emulated in plain PyTorch (`_emulate_kernels`)
with the constants read from the source, and held against the plain version
and the Pallas kernel.  G comes from the card's occupancy, so several are
tried.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_tpu.ops import fused_chain_backward as tpu_chain
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.blocks import DepthwiseConvBN
from ssdseglib_torch.ops import fused_chain_backward as chain
from tests.torch_parity import (  # noqa: F401 (two_torch_threads: autouse fixture)
    source_constants,
    ticket_sum,
    two_torch_threads,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# non-square, channel counts that are not a power of two: a transposed tap or
# a wrong channel stride shows
SHAPES = [(2, 16, 24, 8), (1, 8, 40, 5), (3, 16, 8, 12)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return dict(
        x=(rng.normal(size=shape) * 2.0).astype(np.float32),
        dy=rng.normal(size=shape).astype(np.float32),
        kernel=(rng.normal(size=(3, 3, 1, c)) * 0.5).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.normal(size=c)).astype(np.float32),
        beta=(0.1 * rng.normal(size=c)).astype(np.float32),
    )


def _assert_sums_close(got, want, name, rtol=2e-4):
    want = np.asarray(want, np.float32)
    limit = rtol * max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - want).max() <= limit, name


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    data = _inputs(sum(shape), shape)
    jx, jdy, jk = (jnp.asarray(data[n], jdt) for n in ("x", "dy", "kernel"))
    jg, jb = jnp.asarray(data["gamma"], jdt), jnp.asarray(data["beta"], jdt)
    _, ju, jmean, jvar = tpu_chain._forward_math(jx, jk, jg, jb)
    want = tpu_chain.dw_bn_relu6_backward(jx, ju, jdy, jk, jg, jb, jmean, jvar,
                                          interpret=True)

    # the same saved tensors go into the port: u, mean, var from the JAX forward
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32)).to(tdt)
    before = chain.dw_bn_relu6_backward.launches
    got = chain.dw_bn_relu6_backward(
        as_t(jx), as_t(ju), as_t(jdy), as_t(jk), as_t(jg), as_t(jb),
        torch.tensor(np.asarray(jmean)), torch.tensor(np.asarray(jvar)))
    assert chain.dw_bn_relu6_backward.launches == before  # a CPU tensor never launches
    dx, dk, dgamma, dbeta = got
    assert dx.dtype == tdt and dx.shape == tuple(shape)
    assert dk.dtype == dgamma.dtype == dbeta.dtype == torch.float32
    assert dk.shape == (3, 3, 1, shape[-1])
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want[0], np.float32), **tol)
    for g, w, name in zip((dk, dgamma, dbeta), want[1:], ("dk", "dgamma", "dbeta")):
        _assert_sums_close(g.numpy(), w, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_unit_matches_autograd_of_plain_composition(dtype):
    """Forward: bit-identical to the plain composition, with f32 statistics
    that are not differentiable.  Gradients: f32 2e-4 / 2e-5; bf16 2e-2, as
    the JAX test, because autograd of the bf16 composition rounds
    intermediates that the fused backward keeps in f32."""
    _, tdt = DTYPES[dtype]
    shape = (2, 16, 24, 8)
    data = _inputs(7, shape)
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).to(tdt)
    x = nchw(data["x"]).contiguous(memory_format=torch.channels_last).requires_grad_()
    weight = torch.tensor(data["kernel"]).permute(3, 2, 0, 1).to(tdt).requires_grad_()
    gamma = torch.tensor(data["gamma"]).to(tdt).requires_grad_()
    beta = torch.tensor(data["beta"]).to(tdt).requires_grad_()
    dy = nchw(data["dy"]).contiguous(memory_format=torch.channels_last)
    leaves = (x, weight, gamma, beta)

    y, mean, var = chain.dw_bn_relu6_chain(*leaves)
    assert mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    copies = chain.dw_bn_relu6_chain.copies
    got = torch.autograd.grad(y, leaves, dy)
    assert chain.dw_bn_relu6_chain.copies == copies  # channels-last: zero-copy views

    u = F.conv2d(x, weight, None, 1, 1, 1, shape[-1])
    u32 = u.float()
    m = u32.mean(dim=(0, 2, 3))
    v = ((u32 * u32).mean(dim=(0, 2, 3)) - m * m).clamp_min(0.0)
    scale = (torch.rsqrt(v + 1e-3) * gamma.float()).view(1, -1, 1, 1)
    z = ((u32 - m.view(1, -1, 1, 1)) * scale + beta.float().view(1, -1, 1, 1)).to(tdt)
    y_ref = torch.clamp(z, 0.0, 6.0)
    assert torch.equal(y, y_ref)
    torch.testing.assert_close(mean, m, rtol=0, atol=0)
    torch.testing.assert_close(var, v, rtol=0, atol=0)
    want = torch.autograd.grad(y_ref, leaves, dy)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for g, w, name in zip(got, want, ("dx", "dk", "dgamma", "dbeta")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = max(1.0, float(w.float().abs().max())) if name != "dx" else 1.0
        np.testing.assert_allclose(g.float().numpy() / scale, w.float().numpy() / scale,
                                   err_msg=name, **tol)


def test_forward_close_to_library_batchnorm_route():
    """The unit's forward (Flax's E[u^2] - E[u]^2 variance, one fused scale)
    against conv -> F.batch_norm -> clamp: not bit-identical, the library
    takes the variance in two passes; within 2e-6 in f32 here."""
    shape = (2, 16, 24, 8)
    data = _inputs(3, shape)
    x = torch.tensor(data["x"]).permute(0, 3, 1, 2)
    weight = torch.tensor(data["kernel"]).permute(3, 2, 0, 1).contiguous()
    gamma, beta = torch.tensor(data["gamma"]), torch.tensor(data["beta"])
    y, _, _ = chain.dw_bn_relu6_chain(x, weight, gamma, beta)
    y_lib = F.batch_norm(F.conv2d(x, weight, None, 1, 1, 1, 8), None, None, gamma, beta,
                         True, 0.01, 1e-3).clamp(0.0, 6.0)
    np.testing.assert_allclose(y.numpy(), y_lib.numpy(), rtol=0, atol=2e-6)


@pytest.fixture
def gates():
    yield blocks
    blocks.set_chain_bwd_impl("aten")
    blocks.set_depthwise_bwd_impl("aten")


def test_module_route_matches_default_route(gates):
    """DepthwiseConvBN with the chain gate on, on an in-envelope shape (the
    JAX test's (1, 128, 256, 32)): same state_dict keys, same running
    statistics (rtol 1e-4 / atol 1e-6), close forward (1e-5) and gradients
    (rtol 5e-3 / atol 5e-4 of each tensor's largest, the JAX test's
    tolerances), and the route really
    went through the chain unit."""
    b, h, w, c = 1, 128, 256, 32
    assert chain.chain_applicable(h, w, c, (3, 3), (1, 1), (1, 1), 6.0)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(b, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2)
    module = DepthwiseConvBN(c, strides=1, relu_max=6.0)
    blocks.init_weights(module, torch.Generator().manual_seed(3))
    start = {k: v.clone() for k, v in module.state_dict().items()}

    def run(impl):
        gates.set_chain_bwd_impl(impl)
        module.load_state_dict(start)
        module.train()
        xin = x.clone().requires_grad_()
        y = module(xin)
        grads = torch.autograd.grad((y * y).sum(), [xin, *module.parameters()])
        return y.detach(), grads, {k: v.clone() for k, v in module.state_dict().items()}

    y_plain, g_plain, s_plain = run("aten")
    calls = []
    original = chain.dw_bn_relu6_backward

    def spy(*args):
        calls.append(args[0].shape)
        return original(*args)

    chain.dw_bn_relu6_backward = spy
    try:
        y_chain, g_chain, s_chain = run("cuda")
    finally:
        chain.dw_bn_relu6_backward = original
    assert calls == [(b, h, w, c)]
    assert set(s_chain) == set(s_plain) == set(start)
    np.testing.assert_allclose(y_chain.numpy(), y_plain.numpy(), rtol=1e-5, atol=1e-5)
    for k in s_plain:
        np.testing.assert_allclose(s_chain[k].numpy(), s_plain[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        if k.startswith("batchnorm.running"):
            assert not torch.equal(s_chain[k], start[k]), k
    for a, bb in zip(g_chain, g_plain):  # sums over 32768 pixels: per tensor scale
        scale = max(1.0, float(bb.abs().max()))
        np.testing.assert_allclose(a.numpy() / scale, bb.numpy() / scale, rtol=5e-3,
                                   atol=5e-4)

    # eval mode and out-of-envelope shapes keep the default route
    gates.set_chain_bwd_impl("cuda")
    calls.clear()
    chain.dw_bn_relu6_backward = spy
    try:
        module.eval()
        module(x.clone().requires_grad_()).sum().backward()
        small = DepthwiseConvBN(c, strides=1, relu_max=6.0).train()
        small(x[:, :, :16, :16].clone().requires_grad_()).sum().backward()
    finally:
        chain.dw_bn_relu6_backward = original
    assert calls == []


def test_gates_and_envelope(gates):
    ok = dict(kernel_size=(3, 3), strides=(1, 1), dilation=(1, 1), relu_max=6.0)
    assert chain.chain_applicable(240, 320, 32, **ok)
    assert not chain.chain_applicable(240, 320, 32, (3, 3), (2, 2), (1, 1), 6.0)
    assert not chain.chain_applicable(240, 320, 32, (3, 3), (1, 1), (2, 2), 6.0)
    assert not chain.chain_applicable(240, 320, 32, (3, 3), (1, 1), (1, 1), None)
    assert not chain.chain_applicable(240, 320, 32, (5, 5), (1, 1), (1, 1), 6.0)
    assert not chain.chain_applicable(120, 160, 144, **ok)  # C > 64
    assert not chain.chain_applicable(8, 8, 8, **ok)        # too small to matter
    # the same verdicts as the JAX package's gate on these shapes
    for args in ((240, 320, 32), (120, 160, 144), (8, 8, 8), (128, 256, 32)):
        assert chain.chain_applicable(*args, **ok) == tpu_chain.chain_applicable(*args, **ok)
    assert blocks.CHAIN_BWD_IMPL == "aten" and blocks.DEPTHWISE_BWD_IMPL == "aten"
    gates.set_chain_bwd_impl("cuda")
    assert blocks.CHAIN_BWD_IMPL == "cuda"
    for setter in (gates.set_chain_bwd_impl, gates.set_depthwise_bwd_impl):
        with pytest.raises(ValueError):
            setter("pallas")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    data = _inputs(1, (1, 4, 6, 3))
    t = {k: torch.tensor(v) for k, v in data.items()}
    mean, var = torch.zeros(3), torch.ones(3)
    args = lambda **kw: [
        {**t, "u": t["x"], "mean": mean, "var": var, **kw}[k]
        for k in ("x", "u", "dy", "kernel", "gamma", "beta", "mean", "var")]
    chain.dw_bn_relu6_backward(*args())
    with pytest.raises(ValueError, match="contiguous"):
        chain.dw_bn_relu6_backward(*args(dy=t["dy"].transpose(1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="differ"):
        chain.dw_bn_relu6_backward(*args(u=t["x"].double()))
    with pytest.raises(ValueError, match="not supported"):
        chain.dw_bn_relu6_backward(*args(x=t["x"].half(), u=t["x"].half(), dy=t["dy"].half()))
    with pytest.raises(ValueError, match="kernel has shape"):
        chain.dw_bn_relu6_backward(*args(kernel=t["kernel"][:2]))
    with pytest.raises(ValueError, match="gamma"):
        chain.dw_bn_relu6_backward(*args(gamma=torch.ones(4)))


def _emulate_kernels(x, u, dy, kernel, coefficients, ctas):
    """The two launches' order of work on NHWC CPU tensors, with ``ctas``
    pass-2 CTAs a channel chunk: (dx, dk (3, 3, 1, C), dgamma, dbeta)."""
    k = source_constants("fused_chain_backward.cu", "kMaxChunk", "kSumsCtas", "kSumsMinRows",
                         "kTileRows", "kTileCols")
    batch, h, w, c = x.shape
    n_pix = batch * h * w
    mean, inv, a_coef, beta = coefficients
    dt = x.dtype
    d = u.float() - mean
    z = (d * a_coef + beta).to(dt).float()
    dz = torch.where((z > 0) & (z <= 6), dy.float(), torch.zeros(()))
    xhat = d * inv
    # pass 1: contiguous pixel ranges
    ctas = min(k["kSumsCtas"], -(-n_pix // k["kSumsMinRows"]))
    rows = -(-n_pix // ctas)
    flat_dz, flat_t = dz.reshape(n_pix, c), (dz * xhat).reshape(n_pix, c)
    partials = torch.stack([torch.cat([flat_dz[p:p + rows].sum(0), flat_t[p:p + rows].sum(0)])
                            for p in range(0, n_pix, rows)])
    sums = ticket_sum(partials)
    dbeta, dgamma = sums[:c], sums[c:]
    bc, dcoef = a_coef * (dbeta / float(n_pix)), a_coef * (dgamma / float(n_pix))
    du = a_coef * dz - bc - dcoef * xhat
    # pass 2: tiles with a one-pixel halo, chunks of channels
    tr, tw = k["kTileRows"], k["kTileCols"]
    cc = 1 << (min(c, k["kMaxChunk"]) - 1).bit_length()
    taps = kernel.float().reshape(9, c)
    du_p = F.pad(du, (0, 0, 1, tw + 1, 1, tr + 1))
    x_p = F.pad(x.float(), (0, 0, 1, tw + 1, 1, tr + 1))
    dx = torch.zeros(x.shape, dtype=torch.float32)
    dk = torch.zeros(9, c)
    for c0 in range(0, c, cc):
        ch = slice(c0, min(c0 + cc, c))
        tile_partials = []
        for b in range(batch):
            for y0 in range(0, h, tr):
                for x0 in range(0, w, tw):
                    g = du_p[b, y0:y0 + tr + 2, x0:x0 + tw + 2, ch]
                    xs = x_p[b, y0:y0 + tr + 2, x0:x0 + tw + 2, ch]
                    out = torch.zeros((tr, tw, g.shape[-1]))
                    part = []
                    for i in range(3):
                        for j in range(3):
                            out = out + taps[i * 3 + j, ch] * g[2 - i:2 - i + tr, 2 - j:2 - j + tw]
                            part.append((xs[i:i + tr, j:j + tw] * g[1:1 + tr, 1:1 + tw]).sum((0, 1)))
                    rows_, cols = min(tr, h - y0), min(tw, w - x0)
                    dx[b, y0:y0 + rows_, x0:x0 + cols, ch] = out[:rows_, :cols]
                    tile_partials.append(torch.stack(part))
        walkers = min(ctas, len(tile_partials))  # CTA i takes tiles i, i + walkers, ...
        cta_partials = []
        for i in range(walkers):
            s = torch.zeros_like(tile_partials[0])
            for t in range(i, len(tile_partials), walkers):
                s = s + tile_partials[t]
            cta_partials.append(s)
        dk[:, ch] = ticket_sum(torch.stack(cta_partials))
    return dx.to(dt), dk.reshape(3, 3, 1, c), dgamma, dbeta


# the shapes above, and one with two channel chunks and ragged tiles
EMULATED_SHAPES = SHAPES + [(1, 20, 18, 40)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,ctas", [(shape, ctas) for shape in EMULATED_SHAPES
                                        for ctas in (1, 3)] + [(SHAPES[0], 264)])
def test_kernel_decomposition_matches_plain_version_and_pallas(shape, ctas, dtype):
    """f32 sums within 1e-6 of the largest magnitude of the plain version's,
    dx within the module's tolerances; against the Pallas kernel the module's
    tolerances."""
    jdt, tdt = DTYPES[dtype]
    data = _inputs(sum(shape) + 1, shape)
    jx, jdy, jk = (jnp.asarray(data[n], jdt) for n in ("x", "dy", "kernel"))
    jg, jb = jnp.asarray(data["gamma"], jdt), jnp.asarray(data["beta"], jdt)
    _, ju, jmean, jvar = tpu_chain._forward_math(jx, jk, jg, jb)
    pallas = tpu_chain.dw_bn_relu6_backward(jx, ju, jdy, jk, jg, jb, jmean, jvar,
                                            interpret=True)
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32)).to(tdt)
    x, u, dy, k, gamma, beta = (as_t(a) for a in (jx, ju, jdy, jk, jg, jb))
    mean, var = torch.tensor(np.asarray(jmean)), torch.tensor(np.asarray(jvar))
    coefficients = chain._coefficients(gamma, beta, mean, var)
    got = _emulate_kernels(x, u, dy, k, coefficients, ctas)
    plain = chain.dw_bn_relu6_backward_reference(x, u, dy, k, gamma, beta, mean, var)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    assert got[0].dtype == tdt
    np.testing.assert_allclose(got[0].float().numpy(), plain[0].float().numpy(), **tol)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(pallas[0], np.float32), **tol)
    for g, p, w, name in zip(got[1:], plain[1:], pallas[1:], ("dk", "dgamma", "dbeta")):
        _assert_sums_close(g.numpy(), p.numpy(), name, rtol=1e-6)
        _assert_sums_close(g.numpy(), w, name)


def test_backward_receives_the_forward_coefficients(monkeypatch):
    """The autograd unit hands the backward the very (mean, inv, A, beta)
    tensors its forward computed z with: the mask is the forward's clip."""
    shape = (2, 16, 24, 8)
    data = _inputs(9, shape)
    x = torch.tensor(data["x"]).permute(0, 3, 1, 2).requires_grad_()
    weight = torch.tensor(data["kernel"]).permute(3, 2, 0, 1).contiguous().requires_grad_()
    gamma = torch.tensor(data["gamma"]).requires_grad_()
    beta = torch.tensor(data["beta"]).requires_grad_()
    forward, backward = [], []
    original_coefficients, original_backward = chain._coefficients, chain.dw_bn_relu6_backward

    def spy_coefficients(*args):
        forward.append(original_coefficients(*args))
        return forward[-1]

    def spy_backward(*args):
        backward.append(args[8])
        return original_backward(*args)

    monkeypatch.setattr(chain, "_coefficients", spy_coefficients)
    monkeypatch.setattr(chain, "dw_bn_relu6_backward", spy_backward)
    y, _, _ = chain.dw_bn_relu6_chain(x, weight, gamma, beta)
    y.backward(torch.tensor(data["dy"]).permute(0, 3, 1, 2))
    assert len(forward) == 1 and len(backward) == 1
    for used, received in zip(forward[0], backward[0]):
        assert received.dtype == torch.float32 and torch.equal(received, used)
    # they are what z was computed with: the forward's output again, bit for bit
    mean, _, a_coef, beta32 = (t.view(1, -1, 1, 1) for t in backward[0])
    u = F.conv2d(x.detach(), weight.detach(), None, 1, 1, 1, shape[-1])
    assert torch.equal(((u - mean) * a_coef + beta32).clamp(0.0, 6.0), y.detach())


def test_coefficients_are_checked():
    data = _inputs(2, (1, 4, 6, 3))
    t = {k: torch.tensor(v) for k, v in data.items()}
    mean, var = torch.zeros(3), torch.ones(3)
    args = (t["x"], t["x"], t["dy"], t["kernel"], t["gamma"], t["beta"], mean, var)
    good = chain._coefficients(t["gamma"], t["beta"], mean, var)
    got = chain.dw_bn_relu6_backward(*args, good)
    want = chain.dw_bn_relu6_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="coefficient inv"):
        chain.dw_bn_relu6_backward(*args, (good[0], good[1].double(), good[2], good[3]))
    with pytest.raises(ValueError, match=r"\(mean, inv, A, beta\)"):
        chain.dw_bn_relu6_backward(*args, good[:3])
