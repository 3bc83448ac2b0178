"""The depthwise 3x3 op of the folded serving forward (`ops/depthwise3x3.py`).

On the CPU, at reduced shapes on two torch threads: its plain version gives
the bits of the route it replaced (`conv2d_same` with groups C, the bias
inside the call, then the clamp) at every geometry the folded forward uses,
on a row window too, and the folded forward's outputs are those of that
route; its uncapped ReLU and h-swish against the written-out formulas; the
fake implementation, ``torch.export`` of the forward with the op in its
graph, and the wrapper's refusals.

Marked ``card`` (skipped without a CUDA card; on the chip, from the
repository's root: ``python -m pytest --noconftest tests/test_torch_depthwise3x3.py
-m card``): the kernel's error against an f32 evaluation is no worse than
the library route's at the serving path's shapes and, with the uncapped ReLU
and the h-swish, at MobileNetV3-Large's; the clamp and the ReLU are the
identity's output clamped, bit for bit; one launch per depthwise conv of a
default forward, and the forward's outputs within the bf16 serving
tolerance of the library route's.  This file imports no JAX."""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.models import fused_inference
from ssdseglib_torch.models.blocks import conv2d_same
from ssdseglib_torch.models.mobilenetv2 import _SEQUENCES
from ssdseglib_torch.ops.depthwise3x3 import depthwise3x3, depthwise3x3_reference
from ssdseglib_torch.parallel import spatial

CFG = ModelConfig(input_image_shape=(96, 128, 3), number_of_classes=4,
                  boxes_per_point=(6, 6, 6, 6), backbone="mobilenetv2",
                  segmentation_dilation_rates=(3, 6, 12))
# depthwise 3x3 convs of one folded forward: block 0, the first block of each
# sequence, the two extra blocks, the ASPP branches, the decoder, eight heads
DEPTHWISE_CONVS = (1 + len(_SEQUENCES) + len(fused_inference.EXTRA_BLOCKS)
                   + len(CFG.segmentation_dilation_rates) + 1 + 8)
# chip_smoke.py's bound on a bf16 forward's raw outputs: of (1 + |reference|) on
# the probabilities, of (1 + the largest |reference|) on the box offsets
BF16_SERVE_TOLERANCE = 3e-2
# (H, W, C, stride, dilation): each geometry of the folded forward, on even and
# odd sizes (SAME pads a stride-2 conv on an even size 0 before, 1 after)
GEOMETRIES = [(12, 16, 16, 1, 1), (11, 13, 16, 1, 1), (12, 16, 24, 2, 1),
              (11, 13, 24, 2, 1), (10, 12, 32, 1, 3), (10, 12, 32, 1, 6),
              (10, 12, 32, 1, 12), (4, 5, 40, 2, 1), (3, 3, 8, 2, 1)]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """PyTorch on two intra-op threads while this module's tests run (the
    suite runs in several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _operands(seed, batch, h, w, c, dtype=torch.bfloat16, device="cpu"):
    """A channels-last NCHW activation in [0, 6) (a ReLU6 output), a folded
    (C, 1, 3, 3) weight and a bias, in ``dtype`` on ``device``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 6, (batch, c, h, w)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(0, 0.4, (c, 1, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32))
    x = x.to(device, dtype).contiguous(memory_format=torch.channels_last)
    weight = weight.to(device, dtype).contiguous(memory_format=torch.channels_last)
    return x, weight, bias.to(device, dtype)


def _act(relu6):
    """`fused_inference._conv`'s name of an activation: a bool for the ReLU6
    or not, else the name itself."""
    if isinstance(relu6, bool):
        return "relu6" if relu6 else None
    return relu6


def _route(x, weight, bias, stride, dilation, relu6):
    """The route the op replaced, `fused_inference._conv`'s library calls:
    `conv2d_same` with groups C (the bias inside the call), then the
    activation's pass (the clamp for the ReLU6)."""
    y = conv2d_same(x, weight, bias, stride, dilation, x.shape[1])
    return fused_inference.ACTIVATIONS[_act(relu6)][1](y)


def _new(x, weight, bias, stride, dilation, relu6):
    return fused_inference._conv(x, weight, bias, stride, depthwise=True, act=_act(relu6),
                                 dilation=dilation)


def _written_out(y, act):
    """The activation written out from its formula, in y's dtype."""
    if act == "relu":
        return y.clamp_min(0.0)
    return y * (y + 3.0).clamp(0.0, 6.0) / 6.0


@pytest.mark.parametrize("with_bias, relu6", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("h, w, c, stride, dilation", GEOMETRIES)
def test_plain_version_is_the_route_bit_for_bit(h, w, c, stride, dilation, with_bias,
                                                        relu6):
    x, weight, bias = _operands(h * w + c, 2, h, w, c)
    bias = bias if with_bias else None
    got = _new(x, weight, bias, stride, dilation, relu6)
    want = _route(x, weight, bias, stride, dilation, relu6)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.permute(0, 2, 3, 1).is_contiguous()  # channels-last, as the route's
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["relu", "hard_swish"])
@pytest.mark.parametrize("h, w, c, stride, dilation", GEOMETRIES[:4] + GEOMETRIES[6:7])
def test_plain_version_activations_against_their_formulas(h, w, c, stride, dilation, act):
    """The uncapped ReLU and the h-swish of the plain version (the library
    route's calls) against ``F.conv2d`` in f32 followed by the written-out
    formula, on the same bf16 operands.  Tolerance: the route rounds twice,
    the conv's output and the activation's, each within 2^-8 of its value in
    bf16, and the h-swish's slope is at most 1.5 (under 2.5 x 2^-8 of the
    conv's output); within 2^-6 of 1 + |conv output|."""
    x, weight, bias = _operands(h * w + c + 1, 2, h, w, c)
    x = x - 3.0  # both sides of the h-swish's knees at -3 and 3
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    pads = (*spatial.same_pad(h, 3, stride, dilation), *spatial.same_pad(w, 3, stride, dilation))
    got = depthwise3x3(nhwc, weight, bias, stride, dilation, pads, activation=act).float()
    z = conv2d_same(x.float(), weight.float(), bias.float(), stride, dilation, c)
    want = _written_out(z, act).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 2.0 ** -6 * (1.0 + z.permute(0, 2, 3, 1).abs())).all())
    assert torch.equal(got.to(torch.bfloat16), _new(x, weight, bias, stride, dilation, act)
                       .permute(0, 2, 3, 1))


@pytest.mark.parametrize("stride, dilation, rows", [(1, 1, (3, 11)), (2, 1, (4, 13)),
                                                    (1, 6, (0, 22))])
def test_row_window_takes_explicit_pads(monkeypatch, stride, dilation, rows):
    """On split rows `window_rows` hands both routes a window of global rows
    and no row padding: the op takes pads (0, 0, left, right) and gives the
    route's bits."""
    x, weight, bias = _operands(11, 2, 24, 20, 16)
    window = x[:, :, rows[0]:rows[1]]
    monkeypatch.setattr(spatial, "window_rows", lambda t, *args, **kwargs: (window, (0, 0)))
    got = _new(x, weight, bias, stride, dilation, True)
    want = _route(x, weight, bias, stride, dilation, True)
    assert got.shape[2] == want.shape[2] == (rows[1] - rows[0] - 2 * dilation - 1) // stride + 1
    assert torch.equal(got, want)


def _state(seed=0):
    """A port model's state with non-trivial BatchNorm (running statistics and
    bias uniform in [0.5, 1.5)), so that the folds matter."""
    from ssdseglib_torch.models.builder import SsdSegModel

    rng = np.random.default_rng(seed)
    state = SsdSegModel(CFG, torch.Generator().manual_seed(seed)).state_dict()
    for key, value in state.items():
        if key.endswith(("running_mean", "running_var", "batchnorm.bias")):
            state[key] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
    return state


@pytest.fixture(scope="module")
def operands():
    return fused_inference.fused_operands(CFG, _state(), torch.bfloat16, "cpu")


def _images(seed, batch=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (batch, 96, 128, 3), dtype=np.uint8))


def test_folded_forward_keeps_the_routes_bits_on_the_cpu(operands, monkeypatch):
    images = _images(3)
    with torch.inference_mode():
        got = fused_inference.fused_forward(CFG, operands, images)
        monkeypatch.setattr(fused_inference, "_depthwise3x3", _route)
        want = fused_inference.fused_forward(CFG, operands, images)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_fake_op_gives_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 11, 13, 24, dtype=torch.bfloat16)
        weight = torch.empty(24, 1, 3, 3, dtype=torch.bfloat16)
        y = depthwise3x3(x, weight, None, 2, 1, (1, 1, 1, 1), 6.0)
        z = depthwise3x3(x, weight, torch.empty(24, dtype=torch.bfloat16), 1, 3, (3, 3, 3, 3))
    assert tuple(y.shape) == (2, 6, 7, 24) and y.dtype == torch.bfloat16
    assert tuple(z.shape) == (2, 11, 13, 24) and z.dtype == torch.bfloat16


def test_fake_op_takes_an_activation():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 11, 13, 24, dtype=torch.bfloat16)
        weight = torch.empty(24, 1, 3, 3, dtype=torch.bfloat16)
        y = depthwise3x3(x, weight, None, 2, 1, (1, 1, 1, 1), activation="hard_swish")
    assert tuple(y.shape) == (2, 6, 7, 24) and y.dtype == torch.bfloat16


def test_op_passes_opcheck():
    x, weight, bias = _operands(5, 2, 6, 7, 16)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    for args in ((nhwc, weight, bias, 2, 1, [0, 1, 0, 1], 6.0),
                 (nhwc, weight, None, 1, 3, [3, 3, 3, 3], None)):
        torch.library.opcheck(torch.ops.ssdseglib.depthwise3x3.default, args)


def test_op_passes_opcheck_with_an_activation():
    x, weight, bias = _operands(5, 2, 6, 7, 16)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    for args in ((nhwc, weight, bias, 2, 1, [0, 1, 0, 1], None, "relu"),
                 (nhwc, weight, None, 1, 3, [3, 3, 3, 3], None, "hard_swish")):
        torch.library.opcheck(torch.ops.ssdseglib.depthwise3x3.default, args)


@pytest.mark.parametrize("relu_cap, activation", [(None, "swish"), (6.0, "relu"),
                                                  (None, "relu6")])
def test_wrapper_rejects_an_unknown_or_doubled_activation(relu_cap, activation):
    x, weight, bias = _operands(6, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="activation"):
        depthwise3x3(x.permute(0, 2, 3, 1).contiguous(), weight, bias, 1, 1, (1, 1, 1, 1),
                     relu_cap, activation)


def test_folded_forward_exports_with_the_op_in_its_graph(operands):
    class Forward(torch.nn.Module):
        def forward(self, operands, images):
            return fused_inference.fused_forward(CFG, operands, images)

    args = (operands, _images(4))
    with torch.no_grad():
        exported = torch.export.export(Forward(), args)
        want = Forward()(*args)
    ops = collections.Counter(str(n.target) for n in exported.graph.nodes
                              if str(n.target).startswith("ssdseglib."))
    assert ops == {"ssdseglib.depthwise3x3.default": DEPTHWISE_CONVS,
                   "ssdseglib.fused_mbconv.default": 10}
    got = exported.module()(*args)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("case", ["float32", "nchw", "5x5", "channels", "bias", "stride",
                                  "pads"])
def test_wrapper_rejects_what_the_kernel_cannot_take(case):
    x, weight, bias = _operands(6, 2, 8, 8, 16)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    args = dict(x=nhwc, weight=weight, bias=bias, stride=1, dilation=1, pads=(1, 1, 1, 1))
    if case == "float32":
        args.update(x=nhwc.float(), weight=weight.float(), bias=bias.float())
    elif case == "nchw":
        args.update(x=x.contiguous().permute(0, 2, 3, 1))  # an NHWC view of NCHW memory
    elif case == "5x5":
        args.update(weight=F.pad(weight, (1, 1, 1, 1)))
    elif case == "channels":
        args.update(weight=weight[:8])
    elif case == "bias":
        args.update(bias=bias[:8])
    elif case == "stride":
        args.update(stride=3)
    else:
        args.update(pads=(1, 1, 1))
    with pytest.raises(ValueError):
        depthwise3x3(**args)


# -- on the card


def _f32_error(fn, x, weight, bias, stride, dilation, relu6):
    """max |fn(bf16 operands) - the f32 evaluation of the same operands|."""
    want = _route(x.float(), weight.float(), bias.float(), stride, dilation, relu6)
    return float((fn(x, weight, bias, stride, dilation, relu6).float() - want).abs().max())


# (B, H, W, C, stride, dilation) of the folded forward at 480x640 (b2) and one
# b128-sized level (block 3's stride-2 conv)
CARD_SHAPES = [(2, 240, 320, 32, 1, 1), (2, 240, 320, 96, 2, 1), (2, 120, 160, 144, 2, 1),
               (2, 60, 80, 192, 2, 1), (2, 30, 40, 384, 1, 1), (2, 30, 40, 576, 2, 1),
               (2, 15, 20, 960, 1, 1), (2, 15, 20, 320, 2, 1), (2, 8, 10, 320, 2, 1),
               (2, 30, 40, 576, 1, 3), (2, 30, 40, 576, 1, 6), (2, 30, 40, 576, 1, 12),
               (2, 120, 160, 256, 1, 1), (128, 120, 160, 144, 2, 1)]


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_error_is_no_worse_than_the_routes(card, shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, h, w, c, stride, dilation = shape
    x, weight, bias = _operands(sum(shape), b, h, w, c, device=card)
    for relu6 in (True, False):
        kernel = _f32_error(_new, x, weight, bias, stride, dilation, relu6)
        route = _f32_error(_route, x, weight, bias, stride, dilation, relu6)
        # the kernel rounds once where the route rounds twice; beyond that, the
        # f32 sums' order (2^-20 of the largest output)
        assert kernel <= route + 2.0 ** -20 * 6.0 * 9, (relu6, kernel, route)


# (B, H, W, C, stride) of MobileNetV3-Large's 3x3 depthwise convs at 480x640
# (b2): blocks 1, 2, 3, 7 and 8-12
MOBILENETV3_SHAPES = [(2, 240, 320, 16, 1), (2, 240, 320, 64, 2), (2, 120, 160, 72, 1),
                      (2, 60, 80, 240, 2), (2, 30, 40, 200, 1), (2, 30, 40, 184, 1),
                      (2, 30, 40, 480, 1), (2, 30, 40, 672, 1)]


@pytest.mark.card
@pytest.mark.parametrize("shape", MOBILENETV3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_activations_at_mobilenetv3_geometries(card, shape, monkeypatch):
    """The uncapped ReLU and the h-swish: the kernel's error against the f32
    evaluation (the conv in f32, then the written-out formula) is no worse
    than the library route's, which rounds twice (the conv's output, then
    the activation's) where the kernel rounds once; beyond that, the f32
    sums' order (2^-20 of the largest |conv output|, over nine taps)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, h, w, c, stride = shape
    x, weight, bias = _operands(sum(shape), b, h, w, c, device=card)
    x = x - 3.0  # both sides of the h-swish's knees at -3 and 3
    z = conv2d_same(x.float(), weight.float(), bias.float(), stride, 1, c)
    for act in ("relu", "hard_swish"):
        want = _written_out(z, act)
        kernel = float((_new(x, weight, bias, stride, 1, act).float() - want).abs().max())
        route = float((_route(x, weight, bias, stride, 1, act).float() - want).abs().max())
        assert kernel <= route + 2.0 ** -20 * float(z.abs().max()) * 9, (act, kernel, route)


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES[:3] + MOBILENETV3_SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_clamp_and_relu_are_the_identity_clamped(card, shape):
    """0 ulps: the kernel's clamp to [0, 6] and its ReLU, applied in f32
    before the one rounding, give the bits of its identity's output clamped
    after it (rounding is monotone, and 0 and 6 are bf16 values)."""
    b, h, w, c, stride = shape[:5]
    dilation = shape[5] if len(shape) > 5 else 1
    x, weight, bias = _operands(sum(shape), b, h, w, c, device=card)
    x = x - 3.0
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    pads = (*spatial.same_pad(h, 3, stride, dilation), *spatial.same_pad(w, 3, stride, dilation))
    identity = depthwise3x3(nhwc, weight, bias, stride, dilation, pads)
    assert torch.equal(depthwise3x3(nhwc, weight, bias, stride, dilation, pads, 6.0),
                       identity.clamp(0.0, 6.0))
    assert torch.equal(depthwise3x3(nhwc, weight, bias, stride, dilation, pads,
                                    activation="relu"), identity.clamp_min(0.0))


@pytest.mark.card
def test_one_launch_per_depthwise_conv_of_a_forward(card):
    from ssdseglib_torch.ops.depthwise3x3 import depthwise3x3 as op

    forward = fused_inference.make_fused_forward(CFG, _state(), device=card)
    images = _images(7).to(card)
    forward(images)
    before = op.launches
    forward(images)
    forward(images)
    assert op.launches - before == 2 * DEPTHWISE_CONVS


@pytest.mark.card
def test_forward_within_the_bf16_tolerance_of_the_route(card, monkeypatch):
    big = ModelConfig(input_image_shape=(480, 640, 3), number_of_classes=4,
                      boxes_per_point=(6, 6, 6, 6), backbone="mobilenetv2",
                      segmentation_dilation_rates=(3, 6, 12))
    operands = fused_inference.fused_operands(big, _state(), torch.bfloat16, card)
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)).to(card)
    with torch.inference_mode():
        got = fused_inference.fused_forward(big, operands, images)
        monkeypatch.setattr(fused_inference, "_depthwise3x3", _route)
        want = fused_inference.fused_forward(big, operands, images)
    for key in want:
        a, b = got[key].float(), want[key].float()
        scale = 1.0 + (b.abs().max() if key == "output-boxes" else b.abs())
        err = float(((a - b).abs() / scale).max())
        assert bool(torch.isfinite(a).all()) and err <= BF16_SERVE_TOLERANCE, (key, err)
