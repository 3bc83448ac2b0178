"""The port's ShuffleNetV2 family against the JAX package's on the CPU, at
96x128 and 0.5x: the same weights (Flax's init distributions with randomised
BatchNorm, bridged by ssdseglib_torch.weights) and the same inputs go through
both.

Tolerances, f32: eval-mode outputs 1e-4 (`test_torch_model.py`'s); train-mode
outputs rtol 1e-4 and atol 1e-4 of 1 + the output's largest magnitude (at
batch 2 the os64 and os128 maps hold 8 and 2 values a channel, and their
train-mode BatchNorm divides by the spread of so few values, which scales the
f32 differences up: measured up to 1.8e-4 on boxes of magnitude 4) and the
running statistics rtol 1e-4, atol 1e-6 (the library's two-pass batch
variance against Flax's E[x^2] - E[x]^2, times the momentum 0.01); the
gradients of one step of the full objective by the metric and
5e-2 limit of `test_torch_train.py` (the f32 noise of stacked train-mode
BatchNorms); the channel shuffle and the SAME max pool exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig, ModelConfig
from ssdseglib_tpu.config import TrainConfig as JaxTrainConfig
from ssdseglib_tpu.models import ShuffleNetV2SsdSegBuilder as JaxBuilder
from ssdseglib_tpu.models.blocks import channel_shuffle as jax_channel_shuffle
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_tpu.models.builder import TrainableModel as JaxTrainableModel
from ssdseglib_tpu.train import Trainer as JaxTrainer

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import EncodingConfig, TrainConfig
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.models import ShuffleNetV2SsdSegBuilder, SsdSegModel
from ssdseglib_torch.models.blocks import channel_shuffle, max_pool_same
from ssdseglib_torch.ops.encoding import make_batch_encoder
from ssdseglib_torch.train import Trainer
from ssdseglib_torch.weights import from_flax_variables, moments_to_flax, to_flax_variables
from tests.torch_parity import images, port_model, randomize_batchnorm, two_torch_threads  # noqa: F401

IMAGE_SHAPE = (96, 128)
OPTIONS = {"plain": (False, False), "extra-dw+residual": (True, True)}
SIZES = ("0.5x", "1x", "1.5x", "2x")
ANCHORS_CFG = AnchorsConfig(  # the four feature maps of the model at 96x128
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)


def _cfg(option: str, size: str = "0.5x") -> ModelConfig:
    extra_depthwise, residuals = OPTIONS[option]
    return ModelConfig(
        input_image_shape=IMAGE_SHAPE + (3,), number_of_classes=4,
        boxes_per_point=(4, 4, 4, 4), backbone="shufflenetv2",
        segmentation_dilation_rates=(3, 6, 12), shufflenet_size=size,
        shufflenet_extra_depthwise=extra_depthwise, shufflenet_residuals=residuals,
    )


def _variables(cfg: ModelConfig):
    """Flax variables of ``cfg``'s model: the port's init (Flax's
    distributions, drawn from a torch.Generator seeded 0, which is quicker
    than compiling the Flax init) with randomised BatchNorm."""
    port = SsdSegModel(PortModelConfig(**vars(cfg)), torch.Generator().manual_seed(0))
    return randomize_batchnorm(to_flax_variables(port.state_dict()))


@pytest.fixture(scope="module", params=list(OPTIONS))
def side(request):
    """(option, JAX module, its variables)."""
    cfg = _cfg(request.param)
    return request.param, JaxSsdSegModel(cfg=cfg), _variables(cfg)


def _compare(expected, got, tol, scaled=False):
    """Each output within rtol ``tol`` and atol ``tol`` (times 1 + the
    output's largest magnitude when ``scaled``)."""
    for key in ("output-mask", "output-labels", "output-boxes"):
        want = np.asarray(expected[key])
        assert tuple(got[key].shape) == want.shape, key
        atol = tol * (1.0 + np.abs(want).max()) if scaled else tol
        np.testing.assert_allclose(got[key].detach().numpy(), want, rtol=tol, atol=atol,
                                   err_msg=key)


def test_eval_outputs_match_jax(side):
    option, module, variables = side
    x = images(1, (2,) + IMAGE_SHAPE + (3,))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port_model(module.cfg, variables)(torch.from_numpy(x))
    assert float(np.asarray(expected["output-mask"]).std()) > 0.01, option  # not degenerate
    _compare(expected, got, 1e-4)


def test_train_mode_outputs_and_running_statistics_match_jax(side):
    option, module, variables = side
    x = images(2, (2,) + IMAGE_SHAPE + (3,))
    expected, mutated = jax.jit(lambda v, x: module.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port = port_model(module.cfg, variables).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _compare(expected, got, 1e-4, scaled=True)
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(mutated["batch_stats"]))
    stats = to_flax_variables(port.state_dict())["batch_stats"]
    assert len(want) > 100
    for path, value in want:
        node = stats
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, value, rtol=1e-4, atol=1e-6, err_msg=str(path))


def _batch(anchors):
    samples = generate_dataset(2, image_shape=IMAGE_SHAPE, seed=3)
    enc = EncodingConfig(num_classes=4, image_shape=IMAGE_SHAPE, iou_threshold=0.35,
                         max_ground_truth_boxes=16)
    labels = np.zeros((2, 16), np.int32)
    boxes = np.zeros((2, 16, 4), np.float32)
    valid = np.zeros((2, 16), bool)
    for i, s in enumerate(samples):
        n = len(s.labels)
        labels[i, :n], boxes[i, :n], valid[i, :n] = s.labels, s.boxes, True
    enc_labels, enc_boxes = make_batch_encoder(anchors, enc, device="cpu")(labels, boxes, valid)
    x = np.stack([s.image for s in samples]).astype(np.float32)
    masks = np.eye(4, dtype=np.float32)[np.stack([s.mask for s in samples])]
    return x, {"output-mask": masks, "output-labels": enc_labels.numpy(),
               "output-boxes": enc_boxes.numpy()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float32)})
    return out


def test_one_step_gradients_match_jax():
    """Every gradient of the full objective (three losses) of one train-mode
    step, by `test_torch_train.py`'s relative-norm metric, with extra
    depthwise convs and residuals (every module of the plain units too)."""
    cfg = _cfg("extra-dw+residual")
    module, variables = JaxSsdSegModel(cfg=cfg), _variables(cfg)
    anchors = Anchors.from_config(ANCHORS_CFG, IMAGE_SHAPE)
    x, targets = _batch(anchors)
    jax_trainer = JaxTrainer(
        model=JaxTrainableModel(module=module, cfg=module.cfg),
        anchors=JaxAnchors.from_config(ANCHORS_CFG, IMAGE_SHAPE),
        config=JaxTrainConfig(batch_size=2))

    def loss(params):
        outputs, _ = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, train=True, mutable=["batch_stats"])
        return jax_trainer._losses_and_metrics(outputs, targets)[0]

    jax_loss, jax_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = _flat(jax.device_get(jax_grads))

    trainer = Trainer(model=port_model(module.cfg, variables), anchors=anchors,
                      config=TrainConfig(batch_size=2), device="cpu")
    state = trainer.init_state(variables=from_flax_variables(variables))
    metrics, grads, _ = trainer.loss_and_grads(state, x, targets)
    got = _flat(moments_to_flax(grads))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_loss), rtol=1e-4)
    assert set(got) == set(want) and len(want) > 200
    floor = 1e-4 * max(np.linalg.norm(v) for v in want.values())
    worst = max((float(np.linalg.norm(got[k] - want[k])
                       / max(np.linalg.norm(want[k]), floor)), k) for k in want)
    assert worst[0] < 5e-2, worst


@pytest.mark.parametrize("shape,groups", [((2, 5, 7, 12), 2), ((1, 3, 4, 48), 2),
                                          ((1, 2, 3, 12), 3)])
def test_channel_shuffle_matches_jax_and_stays_channels_last(shape, groups):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    expected = np.asarray(jax_channel_shuffle(jnp.asarray(x), groups))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels-last NCHW view
    got = channel_shuffle(xt, groups)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), expected)
    contiguous = channel_shuffle(xt.contiguous(), groups)
    np.testing.assert_array_equal(contiguous.permute(0, 2, 3, 1).numpy(), expected)


@pytest.mark.parametrize("hw", [(48, 64), (15, 21), (3, 4), (1, 1)])
def test_max_pool_same_matches_flax(hw):
    """Negative inputs, so padding with 0 instead of -inf would show."""
    import flax.linen as nn

    x = np.random.default_rng(1).normal(-2.0, 1.0, size=(2,) + hw + (5,)).astype(np.float32)
    expected = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("size", SIZES)
def test_parameter_tree_and_counts_match_flax_init(size, option):
    """Every leaf of the Flax init (shapes from `jax.eval_shape`, no compute)
    is one torch tensor of the transposed shape, and back; the parameter
    counts are those of the JAX package's `count_parameters`."""
    from ssdseglib_tpu.models.builder import count_parameters as jax_count_parameters

    cfg = _cfg(option, size)
    module = JaxSsdSegModel(cfg=cfg)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1,) + cfg.input_image_shape), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = SsdSegModel(PortModelConfig(**vars(cfg)), torch.Generator().manual_seed(0))
    state = port.state_dict()
    bridged = from_flax_variables(zeros)
    assert set(bridged) == set(state)
    for key, tensor in bridged.items():
        assert tuple(tensor.shape) == tuple(state[key].shape), key
    back = _flat(to_flax_variables(state))
    flax_leaves = _flat(jax.tree_util.tree_map(np.asarray, zeros))
    assert set(back) == set(flax_leaves)
    for path, value in flax_leaves.items():
        assert back[path].shape == value.shape, path
    assert port.parameter_counts() == jax_count_parameters(shapes)
    assert "backbone.backbone-stage1-conv.bias" in state


def test_builder_validates_the_model_size():
    kwargs = dict(input_image_shape=(96, 128, 3), use_additional_depthwise_convolution=False,
                  use_residual_connections=False, number_of_boxes_per_point=4,
                  number_of_classes=4, center_x_boxes_default=[1.0], center_y_boxes_default=[1.0],
                  width_boxes_default=[1.0], height_boxes_default=[1.0],
                  standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))
    with pytest.raises(ValueError) as jax_error:
        JaxBuilder(model_size="3x", **kwargs)
    with pytest.raises(ValueError) as port_error:
        ShuffleNetV2SsdSegBuilder(model_size="3x", **kwargs)
    assert str(port_error.value) == str(jax_error.value)


def test_serving_unfused_f32_and_bf16_against_jax_and_fused_refused():
    """The builder's serving path on ShuffleNetV2 (0.5x, extra depthwise and
    residuals): unfused f32 equal to the JAX package's InferenceModel within
    `test_torch_serving.py`'s f32 tolerances, bf16 within its 3e-2 on the
    mask; ``fused_backbone=True`` refused with the JAX package's error."""
    anchors = Anchors.from_config(ANCHORS_CFG, IMAGE_SHAPE)
    args = dict(
        input_image_shape=IMAGE_SHAPE + (3,), model_size="0.5x",
        use_additional_depthwise_convolution=True, use_residual_connections=True,
        number_of_boxes_per_point=4, number_of_classes=4,
        center_x_boxes_default=anchors.center_x, center_y_boxes_default=anchors.center_y,
        width_boxes_default=anchors.width, height_boxes_default=anchors.height,
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))
    nms = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
               boxes_iou_threshold=0.5, labels_probability_threshold=0.26,
               suppress_background_boxes=False, use_segmentation_suppression=True)
    jax_builder = JaxBuilder(**args)
    jax_builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12))
    variables = _variables(_cfg("extra-dw+residual"))
    x = images(4, (4,) + IMAGE_SHAPE + (3,))
    mask_j, det_j = jax_builder.get_model_for_inference(model_trained=variables, **nms).predict(x)

    builder = ShuffleNetV2SsdSegBuilder(**args)
    model = builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12), device="cpu")
    model.load_state_dict(from_flax_variables(variables))
    mask, det = builder.get_model_for_inference(model_trained=model, device="cpu", **nms).predict(x)
    assert (det[..., 1] > 0).sum() >= 4
    np.testing.assert_allclose(mask, mask_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(det[..., 0], det_j[..., 0])
    np.testing.assert_allclose(det[..., 1:], det_j[..., 1:], rtol=1e-4, atol=1e-4)

    mask_b, det_b = builder.get_model_for_inference(
        model_trained=model, device="cpu", compute_dtype="bfloat16", **nms).predict(x)
    assert mask_b.dtype == np.float32 and np.isfinite(det_b).all()
    np.testing.assert_allclose(mask_b, mask_j, atol=3e-2)

    with pytest.raises(ValueError) as jax_error:
        jax_builder.get_model_for_inference(model_trained=variables, fused_backbone=True, **nms)
    with pytest.raises(ValueError) as port_error:
        builder.get_model_for_inference(model_trained=model, device="cpu",
                                        fused_backbone=True, **nms)
    assert str(port_error.value) == str(jax_error.value)


def test_mixed_precision_step_runs_the_stem_conv_bias_in_bf16():
    """The stage-1 conv's bias is the one conv bias of the family: in a bf16
    step it runs in bf16 with the conv (the f32 BatchNorm parameters stay
    f32), and its gradient reaches the f32 master."""
    cfg = _cfg("plain")
    anchors = Anchors.from_config(ANCHORS_CFG, IMAGE_SHAPE)
    x, targets = _batch(anchors)
    trainer = Trainer(model=port_model(cfg, _variables(cfg)), anchors=anchors,
                      config=TrainConfig(batch_size=2, compute_dtype="bfloat16"), device="cpu")
    state = trainer.init_state()
    leaves, _ = trainer._compute_variables(state.params, state.batch_stats)
    bias = "backbone.backbone-stage1-conv.bias"
    assert leaves[bias].dtype == torch.bfloat16
    assert leaves["backbone.backbone-stage1-conv.weight"].dtype == torch.bfloat16
    assert leaves["heads.labels1.sepconv.batchnorm.bias"].dtype == torch.float32
    before = state.params[bias].clone()
    state, metrics = trainer.train_step(state, x, targets)
    assert np.isfinite(float(metrics["loss"]))
    assert state.params[bias].dtype == torch.float32 and not torch.equal(state.params[bias], before)
