"""MobileNetV3-Large in the port (`models/mobilenetv3.py`, its folded serving
forward in `models/fused_inference.py`), on the CPU at 96x128 on seeded
random weights with non-trivial BatchNorm (running statistics and bias
drawn from uniform(0.5, 1.5), so that folding matters):

- the backbone's three taps against the tests' plain reference
  (`tests/torch_mobilenetv3_reference.py`), and the whole f32 model against
  the benchmark's plain reference network with its MobileNetV3-Large file;
- the folded forward in f32 against the unfolded module, and in bf16
  against the f32 reference, with a tolerance that the reference computed
  in fp8 fails;
- one training step's gradients against the plain reference's autograd;
- the builder's surface and refusals, the two counters, the backward gates
  on a 5x5 depthwise conv, and a serving bundle round trip.

Imports no JAX."""

import types

import numpy as np
import pytest
import torch

from benchmark.reference import model as bench_model
from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.export import load_serving_bundle
from ssdseglib_torch.models import blocks, fused_inference
from ssdseglib_torch.models.builder import (
    MobileNetV3LargeSsdSegBuilder,
    ShuffleNetV2SsdSegBuilder,
    SsdSegModel,
)
from ssdseglib_torch.models.mobilenetv3 import BNECK, MobileNetV3LargeBackbone
from tests import torch_mobilenetv3_reference as reference

CFG = ModelConfig(input_image_shape=(96, 128, 3), number_of_classes=4,
                  boxes_per_point=(6, 6, 6, 6), backbone="mobilenetv3_large",
                  segmentation_dilation_rates=(3, 6, 12))
N_BOXES = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6  # anchors at 96x128
NMS = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
           boxes_iou_threshold=0.5, labels_probability_threshold=0.26,
           use_segmentation_suppression=True, suppress_background_boxes=False)
# the benchmark reference's configuration of CFG
MODEL = {"backbone": "mobilenetv3_large", "input_image_shape": [96, 128, 3],
         "number_of_classes": 4, "boxes_per_point": [6, 6, 6, 6],
         "segmentation_dilation_rates": [3, 6, 12]}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """PyTorch on two intra-op threads while this module's tests run (the
    suite runs in several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _randomize_batchnorm(state, seed=0):
    rng = np.random.default_rng(seed)
    out = dict(state)
    for key, value in state.items():
        if key.endswith(("running_mean", "running_var", "batchnorm.bias")):
            out[key] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
        elif key.endswith("-se-reduce.bias") or key.endswith("-se-expand.bias"):
            out[key] = torch.from_numpy(rng.uniform(-0.5, 0.5, value.shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def model():
    net = SsdSegModel(CFG, torch.Generator().manual_seed(0))
    net.load_state_dict(_randomize_batchnorm(net.state_dict()))
    return net.eval()


def _images(seed, batch=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (batch, 96, 128, 3), dtype=np.uint8))


def _reference_backbone(state, dtype=torch.float32):
    ref = reference.MobileNetV3Large()
    ref.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                         if k.startswith("backbone.") and "num_batches_tracked" not in k})
    return ref.to(dtype)


def test_backbone_is_table_1():
    """Table 1's channel plan: 15 bneck blocks, 8 squeeze-and-excitations at
    24, 32, 32, 120, 168, 168, 240, 240 channels, six 5x5 depthwise convs,
    and 2,971,952 parameters: the 5,483,032 of the published
    MobileNetV3-Large less its classifier's 960 x 1280 + 1280 + 1280 x 1000
    + 1000."""
    backbone = MobileNetV3LargeBackbone()
    assert len(BNECK) == 15 and sum(k == 5 for k, *_ in BNECK) == 6
    se = [backbone[f"backbone-block{n}-se-reduce"].out_channels
          for n in range(1, 16) if f"backbone-block{n}-se-reduce" in backbone]
    assert se == [24, 32, 32, 120, 168, 168, 240, 240]
    assert "backbone-block1-expand" not in backbone
    assert sum(p.numel() for p in backbone.parameters()) == 5_483_032 - (
        960 * 1280 + 1280 + 1280 * 1000 + 1000)


def test_backbone_taps_equal_the_plain_reference(model):
    """f32, eval mode.  Tolerance: rtol 1e-5 of each tap's largest value
    (the two sum the same products in another order)."""
    x = _images(1).float().permute(0, 3, 1, 2) / 127.5 - 1.0
    with torch.no_grad():
        _, taps = model["backbone"](x)
        want = _reference_backbone(model.state_dict()).eval()(x)
    got = [taps[name] for name in model.taps]
    assert [tuple(t.shape[1:]) for t in got] == [(672, 6, 8), (960, 3, 4), (72, 24, 32)]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_whole_model_equals_the_benchmark_reference(model):
    """The f32 `SsdSegModel` against the benchmark's plain reference network
    (`benchmark/reference/backbones/mobilenetv3_large.py` on its heads) on
    the same weights: as `benchmark/tests/test_bench_reference.py` holds
    the other backbones (1e-5 on probabilities, 1e-4 of the largest box
    offset)."""
    images = _images(2)
    ref = bench_model.build(MODEL, model.state_dict(), "cpu")
    with torch.no_grad():
        out = model(images.float())
        mask, labels, boxes = ref(images.float())
    assert (out["output-mask"] - mask).abs().max() < 1e-5
    assert (out["output-labels"] - labels).abs().max() < 1e-5
    assert (out["output-boxes"] - boxes).abs().max() <= 1e-4 * boxes.abs().max()


def test_folded_f32_forward_equals_the_module(model):
    """Tolerance 1e-4 (of 1 + |module| on probabilities, of 1 + its largest
    |box offset|): folding the BatchNorms into the kernels and the rescale
    into the stem reorders the sums."""
    forward = fused_inference.make_fused_forward(CFG, model.state_dict(), torch.float32, "cpu")
    images = _images(3)
    with torch.no_grad():
        want = model(images.float())
    got = forward(images)
    for key in want:
        scale = 1.0 + (want[key].abs().max() if key == "output-boxes" else want[key].abs())
        assert float(((got[key] - want[key]).abs() / scale).max()) < 1e-4, key


# bf16 serving against the f32 reference: the mean |difference| of the mask
# probabilities and the largest |difference| of the box offsets over 1 + the
# largest |offset|.  On these weights and images (and on two more image
# seeds) the folded bf16 forward reads 0.00040 and 0.0038-0.0048; the
# reference computed in fp8 (`benchmark.reference.model.precision("fp8")`,
# the next precision below bf16) reads 0.0043-0.0047 and 0.042-0.056.  Each
# tolerance lies near the geometric mean of the two.
BF16_MASK_MEAN = 0.0013
BF16_BOXES = 0.015


def _serving_errors(mask, boxes, want_mask, want_boxes):
    return (float((mask.float() - want_mask).abs().mean()),
            float((boxes.float() - want_boxes).abs().max() / (1.0 + want_boxes.abs().max())))


def test_folded_bf16_forward_within_a_tolerance_that_fp8_fails(model):
    forward = fused_inference.make_fused_forward(CFG, model.state_dict(), torch.bfloat16, "cpu")
    images = _images(4, batch=4)
    ref = bench_model.build(MODEL, model.state_dict(), "cpu")
    with torch.no_grad():
        want_mask, _, want_boxes = ref(images.float())
        with bench_model.precision("fp8"):
            fp8_mask, _, fp8_boxes = ref(images.float())
    got = forward(images)
    bf16 = _serving_errors(got["output-mask"], got["output-boxes"], want_mask, want_boxes)
    fp8 = _serving_errors(fp8_mask, fp8_boxes, want_mask, want_boxes)
    assert bf16[0] <= BF16_MASK_MEAN and bf16[1] <= BF16_BOXES, bf16
    assert fp8[0] > BF16_MASK_MEAN and fp8[1] > BF16_BOXES, fp8


def test_one_training_step_s_gradients_equal_the_reference_s(model):
    """Train mode (batch statistics), in float64 so that the stacked
    BatchNorms' f32 noise does not hide a difference: the gradients of a
    fixed linear function of the three taps with respect to every backbone
    parameter, the port's autograd against the plain reference's; each
    within 1e-6 of its norm (float64 sums in another order), or of 1e-9 of
    the largest gradient's norm where the gradient vanishes (a BatchNorm
    bias whose output reaches the loss only through train-mode BatchNorms,
    which subtract it again)."""
    port = MobileNetV3LargeBackbone()
    port.load_state_dict({k[len("backbone."):]: v for k, v in model.state_dict().items()
                          if k.startswith("backbone.")})
    port = port.double().train()
    ref = _reference_backbone(model.state_dict(), torch.float64).train()
    x = _images(5, batch=3).double().permute(0, 3, 1, 2) / 127.5 - 1.0
    gen = torch.Generator().manual_seed(1)

    def loss(taps):
        return sum((t * torch.randn(t.shape, generator=gen, dtype=t.dtype)).sum() for t in taps)

    _, taps = port(x)
    loss([taps[name] for name in model.taps]).backward()
    gen.manual_seed(1)
    loss(ref(x)).backward()
    ours = dict(port.named_parameters())
    theirs = dict(ref.named_parameters())
    assert set(ours) == set(theirs)
    floor = 1e-9 * max(float(p.grad.norm()) for p in theirs.values())
    for name, p in ours.items():
        want = theirs[name].grad
        assert float((p.grad - want).norm()) <= 1e-6 * float(want.norm()) + floor, name


def _builder():
    rng = np.random.default_rng(0)
    return MobileNetV3LargeSsdSegBuilder(
        input_image_shape=(96, 128, 3), number_of_boxes_per_point=6, number_of_classes=4,
        center_x_boxes_default=rng.uniform(0, 128, N_BOXES).astype(np.float32),
        center_y_boxes_default=rng.uniform(0, 96, N_BOXES).astype(np.float32),
        width_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        height_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))


def test_builder_serves_folded_bf16_and_counts(model):
    """The normal path: `get_model_for_inference(..., compute_dtype=
    "bfloat16", fused_backbone=True, mask_output="bfloat16")`; a forward
    runs 8 squeeze-and-excitations and leaves the six 5x5 depthwise convs
    to the library (all 15 in f32), the nine 3x3 ones and the heads' 14 to
    the depthwise op."""
    from ssdseglib_torch.ops import depthwise3x3 as op

    builder = _builder()
    trained = builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12),
                                             device="cpu")
    assert trained.cfg.backbone == "mobilenetv3_large"
    trained.load_state_dict(model.state_dict())
    counters = fused_inference.mobilenetv3_large_features_fused
    for dtype, library in (("bfloat16", 6), ("float32", 15)):
        infer = builder.get_model_for_inference(trained, compute_dtype=dtype,
                                                fused_backbone=True, mask_output=dtype,
                                                device="cpu", **NMS)
        before = (counters.se_blocks, counters.library_depthwise)
        calls = []
        real = op.depthwise3x3_reference

        def count(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        op.depthwise3x3_reference = count
        try:
            mask, det = infer(_images(6).numpy())
        finally:
            op.depthwise3x3_reference = real
        assert (counters.se_blocks - before[0], counters.library_depthwise - before[1]) == (
            8, library)
        assert len(calls) == (9 + 14 if dtype == "bfloat16" else 0)
        assert mask.dtype == getattr(torch, dtype) and tuple(det.shape) == (2, 10, 6)


@pytest.mark.parametrize("option", ["quantize_pointwise", "s2d_stem", "spatial_mesh"])
def test_builder_refuses_mobilenetv2_s_options(model, option):
    kwargs = {"quantize_pointwise": dict(quantize_pointwise=True,
                                         calibration_images=_images(7).numpy()),
              "s2d_stem": dict(s2d_stem="cuda"),
              # a ("data", "spatial") mesh is refused by its axes' names,
              # before any of its groups is read
              "spatial_mesh": dict(mesh=types.SimpleNamespace(
                  mesh_dim_names=("data", "spatial")))}[option]
    with pytest.raises(ValueError, match="mobilenetv3_large"):
        _builder().get_model_for_inference(model, compute_dtype="bfloat16",
                                           fused_backbone=True, device="cpu", **NMS, **kwargs)
    if option != "spatial_mesh":
        with pytest.raises(ValueError, match="mobilenetv3_large"):
            fused_inference.make_fused_forward(CFG, model.state_dict(), device="cpu", **kwargs)


def test_shufflenet_folded_still_raises_and_unknown_backbones_are_refused():
    rng = np.random.default_rng(0)
    builder = ShuffleNetV2SsdSegBuilder(
        input_image_shape=(96, 128, 3), model_size="0.5x",
        use_additional_depthwise_convolution=False, use_residual_connections=False,
        number_of_boxes_per_point=6, number_of_classes=4,
        center_x_boxes_default=rng.uniform(0, 128, N_BOXES).astype(np.float32),
        center_y_boxes_default=rng.uniform(0, 96, N_BOXES).astype(np.float32),
        width_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        height_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))
    net = builder.get_model_for_training(device="cpu")
    with pytest.raises(ValueError, match="fused inference currently supports mobilenetv2"):
        builder.get_model_for_inference(net, fused_backbone=True, device="cpu", **NMS)
    with pytest.raises(ValueError, match="unknown backbone 'mobilenetv3_small'"):
        SsdSegModel(ModelConfig(backbone="mobilenetv3_small"), torch.Generator())


@pytest.mark.parametrize("gate", ["depthwise_shift", "depthwise_bwd_cuda", "chain_bwd_cuda"])
def test_backward_gates_take_a_5x5_depthwise_conv_or_leave_it_to_aten(gate, monkeypatch):
    """Train mode, a 5x5 DepthwiseConvBN with the ReLU6 (the chain's own
    activation) and, for the chain, a 3x3 one with the h-swish, each inside
    the kernels' envelope but for its kernel size or activation: under each
    opt-in gate the output and the gradients are those of the default
    route.  The shift formulation takes the 5x5 conv (K*K shifted products:
    the sums' order, 1e-5 of the outputs and the input gradient, 1e-4 of
    the weight gradient, whose 131,072 products a tap are summed in another
    order); the two kernels' gates leave them to ATen (the kernels are
    replaced by a stand-in that fails if called)."""
    from ssdseglib_torch.ops import depthwise_backward, fused_chain_backward

    def unreachable(*args, **kwargs):
        raise AssertionError("the 5x5 conv reached a 3x3 backward kernel")

    monkeypatch.setattr(depthwise_backward, "depthwise_conv3x3_fused_bwd", unreachable)
    monkeypatch.setattr(fused_chain_backward, "dw_bn_relu6_chain", unreachable)
    torch.manual_seed(0)
    # channels and map above the kernels' envelope floor (h * w * c >= 1e6)
    layers = [blocks.DepthwiseConvBN(16, 5, relu_max=6.0)]
    if gate == "chain_bwd_cuda":
        layers.append(blocks.DepthwiseConvBN(16, 3, activation="hard_swish"))
    x = torch.randn(2, 16, 256, 256).contiguous(memory_format=torch.channels_last)

    def run():
        outs, grads = [], []
        for layer in layers:
            layer.train()
            leaf = x.clone().requires_grad_()
            y = layer(leaf)
            y.square().sum().backward()
            outs.append(y.detach())
            grads.append((leaf.grad, layer.conv.weight.grad.clone()))
            layer.conv.weight.grad = None
        return outs, grads

    want = run()
    setter, value = {"depthwise_shift": (blocks.set_depthwise_impl, "shift"),
                     "depthwise_bwd_cuda": (blocks.set_depthwise_bwd_impl, "cuda"),
                     "chain_bwd_cuda": (blocks.set_chain_bwd_impl, "cuda")}[gate]
    default = {"depthwise_shift": "conv"}.get(gate, "aten")
    setter(value)
    try:
        got = run()
    finally:
        setter(default)
    for a, b in zip(got[0], want[0]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    for (ga, gw), (wa, ww) in zip(got[1], want[1]):
        assert float((ga - wa).norm()) <= 1e-5 * float(wa.norm())
        assert float((gw - ww).norm()) <= 1e-4 * float(ww.norm())


def test_serving_bundle_round_trips(model, tmp_path):
    """`export_serving_bundle` then `load_serving_bundle` on the CPU: the
    reloaded bf16 folded program gives the live model's bits."""
    builder = _builder()
    builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12), device="cpu")
    infer = builder.get_model_for_inference(model, compute_dtype="bfloat16",
                                            fused_backbone=True, mask_output="bfloat16",
                                            device="cpu", **NMS)
    infer.export_serving_bundle(str(tmp_path / "bundle"), batch=(2,))
    bundle = load_serving_bundle(str(tmp_path / "bundle"))
    images = _images(8).numpy()
    mask, det = infer(images)
    got_mask, got_det = bundle(images)
    assert torch.equal(got_mask, mask) and torch.equal(got_det, det)
