"""The slice as a whole: the port's serving path (builder -> BN-folded
forward with the fused MBConv wrapper -> decode -> gating -> exact NMS)
against the JAX package's plain InferenceModel on the same weights and
images, on the CPU at 96x128."""

import jax
import numpy as np
import pytest
import torch

from ssdseglib_tpu.models import MobileNetV2SsdSegBuilder as JaxBuilder
from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder as PortBuilder
from ssdseglib_torch.weights import from_flax_variables
from tests.torch_parity import images, randomize_batchnorm

N_BOXES = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6  # anchors at 96x128
NMS = dict(
    max_number_of_boxes_per_class=4,
    max_number_of_boxes_per_sample=10,
    boxes_iou_threshold=0.5,
    labels_probability_threshold=0.26,
    suppress_background_boxes=False,
    use_segmentation_suppression=True,
)


def _builder_args():
    rng = np.random.default_rng(0)
    return dict(
        input_image_shape=(96, 128, 3),
        number_of_boxes_per_point=6,
        number_of_classes=4,
        center_x_boxes_default=rng.uniform(0, 128, N_BOXES).astype(np.float32),
        center_y_boxes_default=rng.uniform(0, 96, N_BOXES).astype(np.float32),
        width_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        height_boxes_default=rng.uniform(5, 40, N_BOXES).astype(np.float32),
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2),
    )


@pytest.fixture(scope="module")
def serving():
    jax_builder = JaxBuilder(**_builder_args())
    trainable = jax_builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12))
    variables = randomize_batchnorm(trainable.init(jax.random.key(0)))
    jax_model = jax_builder.get_model_for_inference(model_trained=variables, **NMS)

    port_builder = PortBuilder(**_builder_args())
    model = port_builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12))
    model.load_state_dict(from_flax_variables(variables))

    def port(**kwargs):
        return port_builder.get_model_for_inference(
            model_trained=model, **{**NMS, **kwargs}
        )

    x = images(1, (16, 96, 128, 3))
    return jax_model, port, x, jax_model.predict(x)


def _assert_detections_equal(got, expected, tol):
    np.testing.assert_array_equal(got[..., 0], expected[..., 0])  # labels, row order
    np.testing.assert_allclose(got[..., 1:], expected[..., 1:], rtol=tol, atol=tol)


def test_fused_f32_predict_matches_jax(serving):
    _, port, x, (mask_j, det_j) = serving
    mask, det = port(fused_backbone=True).predict(x)
    assert mask.shape == (16, 96, 128, 4) and mask.dtype == np.float32
    assert det.shape == (16, 10, 6)
    valid = det[..., 1] > 0
    assert valid.sum(axis=1).min() >= 3  # several valid rows in every image
    np.testing.assert_allclose(mask, mask_j, rtol=2e-3, atol=2e-3)
    _assert_detections_equal(det, det_j, 1e-4)


@pytest.mark.parametrize("mask_output", ["float32", "bfloat16", "class_map"])
def test_fused_bf16_output_formats(serving, mask_output):
    _, port, x, (mask_j, det_j) = serving
    model = port(fused_backbone=True, compute_dtype="bfloat16", mask_output=mask_output)
    mask_t, det_t = model(x)
    assert det_t.dtype == torch.float32 and tuple(det_t.shape) == (16, 10, 6)
    assert torch.isfinite(det_t).all()
    if mask_output == "class_map":
        assert mask_t.dtype == torch.uint8 and tuple(mask_t.shape) == (16, 96, 128)
        agree = (mask_t.numpy() == mask_j.argmax(-1)).mean()
        assert agree > 0.9, agree  # bf16 flips only near-ties
        return
    assert mask_t.dtype == getattr(torch, mask_output)
    assert tuple(mask_t.shape) == (16, 96, 128, 4)
    mask, _ = model.predict(x)
    assert mask.dtype == np.float32
    np.testing.assert_allclose(mask, mask_j, atol=3e-2)


def test_set_nms_operating_point_changes_result_without_rebuild(serving):
    jax_model, port, x, (_, det_j) = serving
    model = port(fused_backbone=True)
    network = model._network
    _, det = model.predict(x)
    model.set_nms_operating_point(boxes_iou_threshold=0.1,
                                  labels_probability_threshold=0.5)
    assert model._network is network
    _, det_strict = model.predict(x)
    assert (det_strict[..., 1] > 0).sum() < (det[..., 1] > 0).sum()
    jax_model.set_nms_operating_point(0.1, 0.5)
    try:
        _, det_strict_j = jax_model.predict(x)
    finally:
        jax_model.set_nms_operating_point(NMS["boxes_iou_threshold"],
                                          NMS["labels_probability_threshold"])
    _assert_detections_equal(det_strict, det_strict_j, 1e-4)


def test_predict_batched_matches_jax_repeat_pad(serving):
    jax_model, port, _, _ = serving
    x = images(2, (20, 96, 128, 3))
    mask_j, det_j = jax_model.predict_batched(x, batch=16)
    mask, det = port(fused_backbone=True).predict_batched(x, batch=16)
    assert mask.shape == (20, 96, 128, 4) and det.shape == (20, 10, 6)
    np.testing.assert_allclose(mask, mask_j, rtol=2e-3, atol=2e-3)
    _assert_detections_equal(det, det_j, 1e-4)


def test_plain_and_fused_paths_agree(serving):
    _, port, x, _ = serving
    mask_p, det_p = port(fused_backbone=False).predict(x[:4])
    mask_f, det_f = port(fused_backbone=True).predict(x[:4])
    np.testing.assert_allclose(mask_f, mask_p, rtol=2e-3, atol=2e-3)
    _assert_detections_equal(det_f, det_p, 1e-4)
    raw_mask, labels, boxes = port(fused_backbone=True).raw_outputs(x[:4])
    assert raw_mask.dtype == torch.float32 and labels.shape == (4, N_BOXES, 4)
    assert boxes.shape == (4, N_BOXES, 4)
