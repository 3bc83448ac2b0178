"""The port's 1x1 weight-gradient routes against the JAX package on the CPU.

- The three plain versions (`wgrad_mma_reference`, `wgrad_copy_reference`,
  `wgrad_fma_reference`) against the three Pallas kernels of
  ``tests/tpu_scripts/mosaic_reshape_probe.py`` run in interpret mode.  The
  probe has no ``interpret`` argument and hard-codes W = 320, Ci = 32,
  Co = 16, so it is loaded from its file and ``pl.pallas_call`` is wrapped
  for the test only; the shape is (2, 32, 320, 32 -> 16).  Tolerance: 1e-4
  absolute and 1e-5 relative on f32 sums of 20480 products of bf16 values
  (|dW| up to ~500), taken in another order by each side.
- `conv2d_fast_wgrad` of the port against the JAX one on the cases of
  ``tests/test_conv_backward.py`` (1x1, 3x3, strided, dilated, grouped):
  forward and input gradient 1e-4 (two libraries' f32 convolutions), weight
  gradient rtol 1e-5 / atol 1e-4 as there; bf16 rtol = atol = 5e-2 as there.
  Inside the port: forward and input gradient bit-identical to the plain
  conv under every route.
- The gate `set_wgrad_impl` leaves names, shapes and forward values as they
  are, and the three gates give the same gradients on a small stack (1e-4).
- `wgrad_fma`'s decomposition -- contiguous ranges of K a CTA in whole
  chunks of rows, the register blocks and their groups taking a chunk's rows
  in turn, the groups' copies summed in group order, the CTAs' partials by
  `finish` -- is emulated in plain PyTorch
  (`_emulate_fma`) with the chunk rows and register blocks read from the
  source, and held against the plain version (within 1e-6 of its largest
  magnitude) and `vpu_kernel` in interpret mode (rtol 2e-4 / atol 2e-5 of
  the largest magnitude, as the depthwise dk), at both layers of the
  model's envelope and a ragged K outside it.
"""

import importlib.util
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.ops.conv_backward import conv2d_fast_wgrad as jax_conv2d_fast_wgrad

from ssdseglib_torch.models import blocks
from ssdseglib_torch.ops import conv_backward, pointwise_wgrad
from ssdseglib_torch.ops.conv_backward import conv2d_fast_wgrad
from tests.torch_parity import (  # noqa: F401 (two_torch_threads: autouse fixture)
    source_constants,
    ticket_sum,
    two_torch_threads,
)

PROBE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpu_scripts",
                     "mosaic_reshape_probe.py")


@pytest.fixture()
def probe(monkeypatch):
    """The probe module with its Pallas calls in interpret mode."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *args, **kwargs: real(*args, **{**kwargs, "interpret": True}))
    spec = importlib.util.spec_from_file_location("mosaic_reshape_probe", PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _operands(shape=(2, 32, 320), ci=32, co=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, ci)).astype(np.float32)
    dy = rng.standard_normal((*shape, co)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("pallas_name, plain", [
    ("pallas_wgrad", pointwise_wgrad.wgrad_mma_reference),
    ("pallas_copyonly", pointwise_wgrad.wgrad_copy_reference),
    ("pallas_vpu", pointwise_wgrad.wgrad_fma_reference),
])
def test_plain_versions_match_pallas_kernels_in_interpret_mode(probe, pallas_name, plain):
    x, dy = _operands()
    want = np.asarray(getattr(probe, pallas_name)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)))
    got = plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16())
    # the port's layout is the weight's (Co, Ci); the probe's is (Ci, Co)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 32)
    np.testing.assert_allclose(got.t().numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrappers_run_their_plain_versions_on_cpu_tensors(dtype):
    """On a CPU tensor a wrapper runs its plain version and counts no
    launch; the three agree with the f64 product of the same values."""
    x, dy = _operands((3, 7, 11), 48, 32, seed=1)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    x64, g64 = xt.double().reshape(-1, 48), gt.double().reshape(-1, 32)
    want = (g64.t() @ x64).numpy()  # (Co, Ci), the weight's layout
    sums = (g64.sum(0)[:, None] + x64.sum(0)[None, :]).numpy()
    counters = (pointwise_wgrad.wgrad_mma, pointwise_wgrad.wgrad_fma, pointwise_wgrad.wgrad_copy)
    before = [c.launches for c in counters]
    np.testing.assert_allclose(pointwise_wgrad.wgrad_fma(xt, gt).numpy(), want, atol=1e-4)
    np.testing.assert_allclose(pointwise_wgrad.wgrad_copy(xt, gt).numpy(), sums, atol=1e-4)
    np.testing.assert_allclose(pointwise_wgrad.pointwise_wgrad(xt, gt).numpy(), want, atol=1e-4)
    np.testing.assert_allclose(pointwise_wgrad.dot_wgrad(xt, gt).t().numpy(), want, atol=1e-4)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(pointwise_wgrad.wgrad_mma(xt, gt).numpy(), want, atol=1e-4)
    else:
        with pytest.raises(ValueError, match="bfloat16"):
            pointwise_wgrad.wgrad_mma(xt, gt)
    assert [c.launches for c in counters] == before


WRAPPERS = {"mma": pointwise_wgrad.wgrad_mma, "fma": pointwise_wgrad.wgrad_fma,
            "pointwise": pointwise_wgrad.pointwise_wgrad}


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_result_is_in_the_weights_layout_and_dtype(name, out_dtype):
    """The contract `_Conv2dFastWgrad` relies on, on CPU tensors: (Co, Ci) --
    the memory of a (Co, Ci, 1, 1) weight -- contiguous, in ``out_dtype``,
    equal to the f32 sums rounded once to that dtype."""
    x, dy = _operands((2, 5, 9), 32, 16, seed=2)
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = WRAPPERS[name](xt, gt, out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == (16, 32) and got.is_contiguous()
    want = gt.double().reshape(-1, 16).t() @ xt.double().reshape(-1, 32)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=8e-3, atol=1e-4)
    with pytest.raises(ValueError, match="out_dtype"):
        WRAPPERS[name](xt, gt, torch.float16)


@pytest.mark.parametrize("weight_format", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_route_returns_the_kernels_result_as_the_weight_gradient(
        monkeypatch, dtype, weight_format):
    """Under impl='cuda' the backward asks the kernel's wrapper for the
    weight's dtype and hands its (Co, Ci) result on as the weight gradient
    itself -- the same memory, the weight's shape and strides -- with no
    copy into another layout."""
    seen = []
    real = conv_backward.pointwise_wgrad

    def spy(x, dy, out_dtype):
        seen.append(real(x, dy, out_dtype))
        return seen[-1]

    monkeypatch.setattr(conv_backward, "pointwise_wgrad", spy)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 6, 5, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    fmt = torch.channels_last if weight_format == "channels_last" else torch.contiguous_format
    w = torch.randn(16, 32, 1, 1, generator=gen).to(dtype).contiguous(
        memory_format=fmt).requires_grad_()
    dy = torch.randn(2, 16, 6, 5, generator=gen).to(dtype)
    (dw,) = torch.autograd.grad(conv2d_fast_wgrad(x, w, impl="cuda"), (w,), dy)
    assert len(seen) == 1 and seen[0].dtype == dtype and tuple(seen[0].shape) == (16, 32)
    assert dw.data_ptr() == seen[0].data_ptr()
    assert dw.dtype == dtype and dw.shape == w.shape and dw.stride() == w.stride()
    want = torch.autograd.grad(blocks.conv2d_same(x.float(), w.float()), (w,), dy.float())[0]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dw.float(), want.float(), rtol=tol, atol=tol)


def test_envelope_and_input_contract():
    ok = pointwise_wgrad.wgrad_applicable
    # the two layers the study names, and the edges of the envelope
    assert ok(32, 16, torch.bfloat16) and ok(16, 96, torch.float32)
    assert ok(64, 32, torch.bfloat16) and ok(32, 64, torch.bfloat16)
    for ci, co in ((24, 48), (96, 24), (16, 144), (64, 64), (80, 16), (8, 16), (16, 112)):
        assert not ok(ci, co, torch.bfloat16), (ci, co)
    assert not ok(32, 16, torch.float16)
    x = torch.zeros(2, 4, 32)
    for bad_x, bad_dy in ((x, torch.zeros(2, 5, 16)), (x, torch.zeros(2, 4, 16).bfloat16()),
                          (x.transpose(0, 1), torch.zeros(4, 2, 16)),
                          (torch.zeros(0, 32), torch.zeros(0, 16)),
                          (torch.zeros(2, 4, 24), torch.zeros(2, 4, 16))):
        with pytest.raises(ValueError):
            pointwise_wgrad.wgrad_fma(bad_x, bad_dy)


def test_a_cuda_tensor_launches_the_kernel_or_raises():
    """No quiet retreat to the plain version: the wrapper's only CPU branch
    tests the tensor's device."""
    source = inspect.getsource(pointwise_wgrad)
    assert source.count('device.type == "cpu"') == 3  # one per wrapper
    assert "except" not in source
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pointwise_wgrad.wgrad_fma(torch.zeros(2, 4, 32, device="cuda"),
                                      torch.zeros(2, 4, 16, device="cuda"))


CASES = [
    # (name, H, W, Cin, Cout, k, stride, dilation, groups)
    ("pointwise", 12, 16, 32, 16, 1, 1, 1, 1),
    ("pointwise_outside_envelope", 12, 16, 24, 40, 1, 1, 1, 1),
    ("dense3x3", 12, 16, 8, 24, 3, 1, 1, 1),
    ("dense3x3_s2_odd", 11, 13, 3, 32, 3, 2, 1, 1),
    ("dense3x3_dilated", 16, 16, 8, 8, 3, 1, 3, 1),
    ("depthwise3x3", 12, 16, 32, 32, 3, 1, 1, 32),
    ("depthwise3x3_s2", 11, 13, 16, 16, 3, 2, 1, 16),
]


def _port_grads(conv, x, w, dy):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()
    y = conv(xt, wt)
    dx, dk = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(), dx.permute(0, 2, 3, 1).numpy(),
            dk.permute(2, 3, 1, 0).numpy())


@pytest.mark.parametrize("impl", ["dot", "cuda"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conv2d_fast_wgrad_matches_jax_and_plain_conv(case, impl):
    _, H, W, Ci, Co, k, s, d, g = case
    rng = np.random.default_rng(7)
    B = 3
    x = rng.standard_normal((B, H, W, Ci)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, Ci // g, Co)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((B, -(-H // s), -(-W // s), Co)).astype(np.float32)

    def loss(x_, k_):
        return jnp.vdot(jax_conv2d_fast_wgrad(x_, k_, (s, s), (d, d), g), dy)

    y_jax = jax_conv2d_fast_wgrad(jnp.asarray(x), jnp.asarray(kernel), (s, s), (d, d), g)
    dx_jax, dk_jax = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(kernel))

    copies = conv2d_fast_wgrad.copies
    y, dx, dk = _port_grads(
        lambda a, b: conv2d_fast_wgrad(a, b, None, s, d, g, impl), x, kernel, dy)
    y_plain, dx_plain, dk_plain = _port_grads(
        lambda a, b: blocks.conv2d_same(a, b, None, s, d, g), x, kernel, dy)
    assert conv2d_fast_wgrad.copies == copies  # channels-last operands: read in place
    # inside the port: only the weight gradient may take another route
    np.testing.assert_array_equal(y, y_plain)
    np.testing.assert_array_equal(dx, dx_plain)
    np.testing.assert_allclose(dk, dk_plain, rtol=1e-5, atol=1e-4)
    if not conv_backward.reformulated(torch.empty(Co, Ci // g, k, k), s, g):
        np.testing.assert_array_equal(dk, dk_plain)  # the library's rule, untouched
    # against the JAX package
    np.testing.assert_allclose(y, np.asarray(y_jax), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx, np.asarray(dx_jax), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dk, np.asarray(dk_jax), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", ["dot", "cuda"])
@pytest.mark.parametrize("k, ci, co", [(3, 16, 8), (1, 32, 16)], ids=["3x3", "1x1"])
def test_conv2d_fast_wgrad_bf16_matches_jax(impl, k, ci, co):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 12, ci)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, ci, co)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((2, 10, 12, co)).astype(np.float32)
    xj, kj, dyj = (jnp.asarray(a, jnp.bfloat16) for a in (x, kernel, dy))

    def loss(k_):
        return jnp.vdot(jax_conv2d_fast_wgrad(xj, k_, (1, 1), (1, 1), 1).astype(jnp.float32),
                        dyj.astype(jnp.float32))

    dk_jax = np.asarray(jax.grad(loss)(kj), dtype=np.float32)
    xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(kernel).bfloat16().permute(3, 2, 0, 1).contiguous().requires_grad_()
    y = conv2d_fast_wgrad(xt, wt, None, 1, 1, 1, impl)
    (dk,) = torch.autograd.grad(y, wt, torch.from_numpy(dy).bfloat16().permute(0, 3, 1, 2))
    assert dk.dtype == torch.bfloat16
    if k == 1:  # the rerouted gradient takes the weight's layout
        assert dk.stride() == wt.stride()
    np.testing.assert_allclose(dk.float().permute(2, 3, 1, 0).numpy(), dk_jax,
                               rtol=0.05, atol=0.05)


def test_bias_gradient_and_bad_impl():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 6, 5, generator=gen).contiguous(memory_format=torch.channels_last)
    w = torch.randn(16, 32, 1, 1, generator=gen).requires_grad_()
    b = torch.randn(16, generator=gen).requires_grad_()
    dy = torch.randn(2, 16, 6, 5, generator=gen)
    want = torch.autograd.grad(blocks.conv2d_same(x, w, b), (w, b), dy)
    for impl in ("dot", "cuda"):
        got = torch.autograd.grad(conv2d_fast_wgrad(x, w, b, impl=impl), (w, b), dy)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
        assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="impl"):
        conv2d_fast_wgrad(x, w, b, impl="xla")
    with pytest.raises(ValueError, match="wgrad impl"):
        blocks.set_wgrad_impl("xla")
    assert blocks.WGRAD_IMPL == "aten"  # the default, and unchanged by the refusal


class _Stack(torch.nn.Module):
    """ConvBN (3x3, stride 2) -> ConvBN (1x1, 16 -> 32, inside the envelope)
    -> SepConvBN: every dense-conv use the gate covers in the blocks."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(1)
        self.a = blocks.ConvBN(4, 16, 3, strides=2, relu_max=6.0)
        self.b = blocks.ConvBN(16, 32, relu_max=6.0)
        self.c = blocks.SepConvBN(32, 8, 3, relu_max=0.0)
        blocks.init_weights(self, gen)

    def forward(self, x):
        return self.c(self.b(self.a(x)))


def test_gate_leaves_names_shapes_and_forward_and_gradients_agree():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 4, 12, 16)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    target = torch.from_numpy(rng.standard_normal((2, 8, 6, 8)).astype(np.float32))
    outs, grads, names = {}, {}, {}
    try:
        for impl in ("aten", "dot", "cuda"):
            blocks.set_wgrad_impl(impl)
            net = _Stack().train()
            names[impl] = {k: tuple(v.shape) for k, v in net.state_dict().items()}
            y = net(x)
            outs[impl] = y.detach()
            params = dict(net.named_parameters())
            grads[impl] = dict(zip(params, torch.autograd.grad(
                ((y - target) ** 2).mean(), list(params.values()))))
    finally:
        blocks.set_wgrad_impl("aten")
    for impl in ("dot", "cuda"):
        assert names[impl] == names["aten"]
        assert torch.equal(outs[impl], outs["aten"])
        for k, g in grads["aten"].items():
            torch.testing.assert_close(grads[impl][k], g, rtol=1e-4, atol=1e-6, msg=k)


def test_model_routes_its_dense_convs_through_the_gate(monkeypatch):
    """A dense conv reaches `conv2d_fast_wgrad` only where the gate gives its
    weight gradient another route: under 'dot' every 1x1 stride-1 dense conv
    (ConvBN, SepConvBN pointwise, the decoder's output conv), under 'cuda'
    those inside the kernels' envelope (backbone-block0-project and
    backbone-block1-expand), under 'aten' none; never a depthwise conv.  The
    forward is the same under every gate."""
    from ssdseglib_torch.config import ModelConfig
    from ssdseglib_torch.models.builder import SsdSegModel

    model = SsdSegModel(ModelConfig(input_image_shape=(64, 64, 3), boxes_per_point=(4, 4, 4, 4)),
                        torch.Generator().manual_seed(0)).eval()
    dense = {id(m.weight): name for name, m in model.named_modules()
             if isinstance(m, blocks.SameConv2d) and m.groups == 1}
    pointwise = [name for name, m in model.named_modules()
                 if isinstance(m, blocks.SameConv2d)
                 and conv_backward.reformulated(m.weight, m.stride[0], m.groups)]
    calls = []
    real = conv_backward.conv2d_fast_wgrad

    def spy(x, weight, bias, stride, dilation, groups, impl):
        calls.append((dense[id(weight)], impl))
        return real(x, weight, bias, stride, dilation, groups, impl)

    monkeypatch.setattr(conv_backward, "conv2d_fast_wgrad", spy)
    x = torch.zeros(1, 64, 64, 3)
    got = {}
    try:
        with torch.no_grad():
            want = model(x)
            assert calls == []
            for impl in ("dot", "cuda"):
                blocks.set_wgrad_impl(impl)
                got[impl] = model(x)
    finally:
        blocks.set_wgrad_impl("aten")
    assert len(dense) > 40 and len(pointwise) > 30
    assert calls[:len(pointwise)] == [(name, "dot") for name in pointwise]
    assert calls[len(pointwise):] == [("backbone.backbone-block0-project.conv", "cuda"),
                                      ("backbone.backbone-block1-expand.conv", "cuda")]
    for impl in got:
        for k in want:
            assert torch.equal(got[impl][k], want[k]), (impl, k)


def _fma_blocks():
    """kFmaBlocks of csrc/pointwise_wgrad.cu: the (BI, BO) register blocks."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ssdseglib_torch", "csrc", "pointwise_wgrad.cu")) as f:
        text = f.read()
    table = re.search(r"kFmaBlocks\[\]\[2\] = \{(.*?)\};", text).group(1)
    return [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}", table)]


def _emulate_fma(x, dy, ctas):
    """`wgrad_fma`'s order of work on CPU tensors with at most ``ctas`` CTAs:
    (Co, Ci) f32."""
    k = source_constants("pointwise_wgrad.cu", "kThreads", "kFmaChunkElems", "kFmaMaxRows")
    threads = k["kThreads"]
    ci, co = x.shape[-1], dy.shape[-1]
    rows = k["kFmaMaxRows"]  # the most rows, a power of two, whose x and dy fit a chunk
    while rows > 1 and rows * (ci + co) > k["kFmaChunkElems"]:
        rows //= 2
    x2, g2 = x.reshape(-1, ci).float(), dy.reshape(-1, co).float()
    n_rows = x2.shape[0]
    def score(block):  # 32 blocks (a warp a copy of dW) first, then the threads kept busy
        blocks = (ci // block[0]) * (co // block[1])
        return blocks == 32, threads // blocks * blocks

    bi, bo = max(((bi, bo) for bi, bo in _fma_blocks() if ci % bi == 0 and co % bo == 0),
                 key=score)  # the first of the best
    blocks = (ci // bi) * (co // bo)
    groups = threads // blocks
    per_cta = -(-n_rows // ctas)
    per_cta = -(-per_cta // rows) * rows  # whole chunks
    partials = []
    for r0 in range(0, n_rows, per_cta):
        copies = torch.zeros(groups, ci, co)  # group g takes rows g, g + groups, ... of a chunk
        for c0 in range(r0, min(r0 + per_cta, n_rows), rows):
            xs, gs = x2[c0:c0 + rows], g2[c0:c0 + rows]  # rows past K: zeros, i.e. absent
            for g in range(groups):
                copies[g] = copies[g] + xs[g::groups].t() @ gs[g::groups]
        total = torch.zeros(ci, co)
        for g in range(groups):  # the groups' copies in group order
            total = total + copies[g]
        partials.append(total.t())
    return ticket_sum(torch.stack(partials))


# (leading axes, Ci, Co): the two layers of the envelope at the probe's
# (2, 32, 320), and a ragged K outside the model
FMA_CASES = [((2, 32, 320), 32, 16), ((2, 32, 320), 16, 96), ((3, 37, 53), 48, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lead, ci, co", FMA_CASES, ids=["32-16", "16-96", "ragged"])
def test_fma_decomposition_matches_plain_version_and_pallas(probe, lead, ci, co, dtype):
    """For one CTA, three, and two an SM of a 132-SM card."""
    x, dy = _operands(lead, ci, co, seed=ci + co)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    plain = pointwise_wgrad.wgrad_fma_reference(xt, gt)
    pallas = None
    if lead[1:] == (32, 320):  # the probe's W; its Ci and Co are module constants
        probe.CI, probe.CO = ci, co
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        pallas = np.asarray(probe.pallas_vpu(jnp.asarray(xt.float().numpy(), jdt),
                                             jnp.asarray(gt.float().numpy(), jdt))).T
    for ctas in (1, 3, 264):
        got = _emulate_fma(xt, gt, ctas)
        assert tuple(got.shape) == (co, ci)
        scale = max(1.0, float(plain.abs().max()))
        assert float((got - plain).abs().max()) <= 1e-6 * scale, ctas
        if pallas is not None:  # f32 sums of 20480 terms: scaled as the module's dk is
            scale = max(1.0, float(np.abs(pallas).max()))
            np.testing.assert_allclose(got.numpy() / scale, pallas / scale, rtol=2e-4,
                                       atol=2e-5)
