"""The port's BN-folded serving forward against the JAX package's
make_fused_forward (Pallas kernels in interpret mode), f32 on the CPU, the
host-side folds against their NumPy originals, and the option path (fused
stem + block 1, top-K NMS) as a whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import layers as tpu_layers
from ssdseglib_tpu.config import NmsConfig
from ssdseglib_tpu.models import fused_inference as tpu_fused
from ssdseglib_tpu.ops import encoding as tpu_encoding
from ssdseglib_tpu.ops import nms as tpu_nms
from ssdseglib_torch import layers as port_layers
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.config import NmsConfig as PortNmsConfig
from ssdseglib_torch.models import fused_inference as port_fused
from ssdseglib_torch.ops import encoding as port_encoding
from ssdseglib_torch.ops import nms as port_nms
from tests.torch_parity import SMALL_CFG, images, jax_model_and_variables, port_model

PORT_CFG = PortModelConfig(**vars(SMALL_CFG))


@pytest.fixture(scope="module")
def setup():
    module, variables = jax_model_and_variables(SMALL_CFG)
    state = port_model(SMALL_CFG, variables).state_dict()
    forward = port_fused.make_fused_forward(PORT_CFG, state, torch.float32, device="cpu")
    return module, variables, state, forward


def _compare(expected, got, tol):
    for key in ("output-mask", "output-labels", "output-boxes"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(expected[key]), rtol=tol, atol=tol,
            err_msg=key,
        )


def test_fused_forward_matches_jax_fused_forward(setup):
    _, variables, _, forward = setup
    x = images(1, (2, 96, 128, 3))
    expected = tpu_fused.make_fused_forward(
        SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True
    )(jnp.asarray(x))
    got = forward(torch.from_numpy(x))
    _compare(expected, got, 2e-3)  # the JAX package's own bound


def test_fused_forward_uint8_input_matches_float(setup):
    _, _, _, forward = setup
    x8 = images(5, (2, 96, 128, 3), np.uint8)
    got8 = forward(torch.from_numpy(x8))
    gotf = forward(torch.from_numpy(x8.astype(np.float32)))
    for key in gotf:
        np.testing.assert_allclose(got8[key].numpy(), gotf[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_fused_forward_off_shape_input_bypasses_rescale_fold(setup):
    """The stem's border bias map is specific to cfg.input_image_shape; any
    other spatial shape takes the standalone rescale and still matches."""
    module, variables, _, forward = setup
    x = images(4, (2, 64, 96, 3))
    expected = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    _compare(expected, forward(torch.from_numpy(x)), 2e-3)


@pytest.mark.parametrize("input_hw", [(480, 640), (96, 128), (15, 21)])
def test_fold_stem_rescale_equals_numpy_original(setup, input_hw):
    _, _, state, _ = setup
    k, b = port_fused.fold_mobilenetv2(state)["backbone-block0-expand"]
    k_jax, b_jax = k.transpose(2, 3, 1, 0), b  # OIHW -> HWIO
    kernel, bias_map = port_fused.fold_stem_rescale(k, b, input_hw)
    kernel_jax, bias_map_jax = tpu_fused.fold_stem_rescale(k_jax, b_jax, input_hw)
    np.testing.assert_array_equal(kernel.transpose(2, 3, 1, 0), kernel_jax)
    np.testing.assert_array_equal(bias_map.transpose(0, 2, 3, 1), bias_map_jax)


def test_folds_equal_jax_folds(setup):
    _, variables, state, _ = setup
    ours = port_fused.fold_mobilenetv2(state)
    theirs = tpu_fused.fold_mobilenetv2(variables)
    assert sorted(ours) == sorted(theirs)
    for name, (k, b) in theirs.items():
        np.testing.assert_array_equal(ours[name][0].transpose(2, 3, 1, 0), k)
        np.testing.assert_array_equal(ours[name][1], b)
    ours = port_fused.fold_heads(state, PORT_CFG)
    theirs = tpu_fused.fold_heads(variables, SMALL_CFG)
    assert sorted(ours) == sorted(theirs)
    for name, arrays in theirs.items():
        for a, b in zip(ours[name], arrays):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_fused_forward_rejects_shufflenet(setup):
    _, _, state, _ = setup
    with pytest.raises(ValueError):
        port_fused.make_fused_forward(PortModelConfig(backbone="shufflenetv2"), state)


def test_make_fused_forward_defaults_to_the_card(setup):
    """Like `get_model_for_inference`: the default device is 'cuda', and
    without a card the call raises instead of moving to the CPU."""
    import inspect

    _, _, state, _ = setup
    parameters = inspect.signature(port_fused.make_fused_forward).parameters
    assert parameters["device"].default == "cuda"
    assert parameters["s2d_stem"].default is False
    assert parameters["fused_heads"].default is True
    assert parameters["fold_input_rescale"].default is True
    if torch.cuda.is_available():
        out = port_fused.make_fused_forward(PORT_CFG, state)(
            torch.zeros(1, 96, 128, 3, device="cuda"))
        assert out["output-mask"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port_fused.make_fused_forward(PORT_CFG, state)


N_BOXES = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6  # anchors at 96x128
STDS = (0.1, 0.1, 0.2, 0.2)
NMS_CFG = dict(max_boxes_per_class=4, max_boxes_per_sample=10, iou_threshold=0.5,
               score_threshold=0.26)


def _anchors_centroids():
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(0, 128, N_BOXES), rng.uniform(0, 96, N_BOXES),
                     rng.uniform(5, 40, N_BOXES), rng.uniform(5, 40, N_BOXES)],
                    axis=-1).astype(np.float32)


def _postprocess_topk(expected, got):
    """Decode + segmentation suppression + ``method="topk"`` NMS on both
    sides: labels and row order exact, scores and boxes 1e-4."""
    anchors = _anchors_centroids()
    labels_j = tpu_layers.SegmentationSuppression()(
        expected["output-mask"], expected["output-labels"])
    boxes_j = tpu_encoding.decode_predictions_to_corners_yx(
        expected["output-boxes"], jnp.asarray(anchors), STDS)
    det_j = tpu_nms.combined_nms(boxes_j, labels_j, NmsConfig(**NMS_CFG), method="topk")
    labels = port_layers.SegmentationSuppression(4)(
        got["output-mask"], got["output-labels"].float())
    boxes = port_encoding.decode_predictions_to_corners_yx(
        got["output-boxes"].float(), torch.from_numpy(anchors), STDS)
    det = port_nms.combined_nms(
        boxes, labels, PortNmsConfig(**NMS_CFG), method="topk",
        iou_threshold=torch.tensor(NMS_CFG["iou_threshold"]),
        score_threshold=torch.tensor(NMS_CFG["score_threshold"]))
    assert int(det["valid"].min()) >= 3  # several valid rows in every image
    np.testing.assert_array_equal(det["valid"].numpy(), np.asarray(det_j["valid"]))
    np.testing.assert_array_equal(det["classes"].numpy(), np.asarray(det_j["classes"]))
    for key in ("scores", "boxes"):
        np.testing.assert_allclose(det[key].numpy(), np.asarray(det_j[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("options", [
    dict(),
    dict(fused_heads=False, fold_input_rescale=False),
], ids=["folded-heads", "module-heads"])
def test_option_path_matches_jax_option_path(setup, options):
    """The option path end to end: fused stem + block 1 (its plain version on the
    CPU, the Pallas kernel in interpret mode on the JAX side), the ten MBConv
    blocks, the heads, then decode, suppression and the top-K NMS."""
    _, variables, state, _ = setup
    x = images(2, (4, 96, 128, 3))
    expected = tpu_fused.make_fused_forward(
        SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True,
        s2d_stem="pallas", **options,
    )(jnp.asarray(x))
    got = port_fused.make_fused_forward(
        PORT_CFG, state, torch.float32, device="cpu", s2d_stem="cuda", **options,
    )(torch.from_numpy(x))
    _compare(expected, got, 2e-3)
    _postprocess_topk(expected, got)


def test_module_heads_and_standalone_rescale_match_jax(setup):
    """``fused_heads=False, fold_input_rescale=False`` (the heads of the
    model as they are, the rescale as a pass of its own) against the same
    options of the JAX package, whose own test holds them to 2e-3."""
    _, variables, state, forward = setup
    x = images(3, (2, 96, 128, 3))
    expected = tpu_fused.make_fused_forward(
        SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True,
        fused_heads=False, fold_input_rescale=False,
    )(jnp.asarray(x))
    got = port_fused.make_fused_forward(
        PORT_CFG, state, torch.float32, device="cpu", fused_heads=False,
        fold_input_rescale=False,
    )(torch.from_numpy(x))
    _compare(expected, got, 2e-3)
    _compare({k: v.numpy() for k, v in forward(torch.from_numpy(x)).items()}, got, 2e-3)


def test_s2d_stem_gate_refuses_a_shape_and_takes_the_plain_stem(setup, monkeypatch):
    """H = 98 is no multiple of 4: the forward takes the six convs, as the
    JAX package does, and equals the default path's output there."""
    _, _, state, forward = setup
    fused = port_fused.make_fused_forward(PORT_CFG, state, torch.float32, device="cpu",
                                          s2d_stem="cuda")

    def refuse(*args):
        raise AssertionError("the stem kernel's wrapper was called")

    monkeypatch.setattr(port_fused, "fused_stem_block1", refuse)
    x = torch.from_numpy(images(6, (2, 98, 128, 3)))
    got, want = fused(x), forward(x)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    with pytest.raises(AssertionError, match="wrapper was called"):
        fused(torch.from_numpy(images(6, (2, 96, 128, 3))))
    assert port_fused.mobilenetv2_features_fused.copies == 0


@pytest.mark.parametrize("bad", ["palas", True, "pallas"])
def test_make_fused_forward_rejects_unknown_s2d_stem(setup, bad):
    _, _, state, _ = setup
    with pytest.raises(ValueError, match="s2d_stem"):
        port_fused.make_fused_forward(PORT_CFG, state, device="cpu", s2d_stem=bad)


def test_make_fused_forward_names_the_queue_of_the_xla_variant(setup):
    """``s2d_stem="xla"`` (the packed conv reformulation, ported) against
    the default path at b4, f32, within the file's bound; a batch of 3
    takes the plain stem and gives the default path's outputs."""
    _, _, state, forward = setup
    xla = port_fused.make_fused_forward(PORT_CFG, state, torch.float32, device="cpu",
                                        s2d_stem="xla")
    x = torch.from_numpy(images(7, (4, 96, 128, 3)))
    got, want = xla(x), forward(x)
    _compare({k: v.numpy() for k, v in want.items()}, got, 2e-3)
    got, want = xla(x[:3]), forward(x[:3])
    _compare({k: v.numpy() for k, v in want.items()}, got, 1e-5)
