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
