"""Serving bundles of the port (`ssdseglib_torch.export`), case by case as
`tests/test_export.py` holds the JAX package's, on the CPU at 96x128: a
reloaded bundle gives the live `InferenceModel`'s bits, and the live
model's outputs match the JAX `InferenceModel` on the same weights.  Also:
the kernels' dispatcher ops (`torch.library.opcheck`), the ops as nodes of
the exported graphs, and a process that loads a bundle without the
model-building code."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssdseglib_tpu.models import MobileNetV2SsdSegBuilder as JaxBuilder
from ssdseglib_tpu.utils import serving as jax_serving
from ssdseglib_torch.export import load_serving_bundle, save_serving_bundle
from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder as PortBuilder
from ssdseglib_torch.utils.serving import plan_batched_chunks
from ssdseglib_torch.weights import from_flax_variables, to_flax_variables
from tests.torch_parity import images, randomize_batchnorm, two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BOXES = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6  # anchors at 96x128
NMS = dict(
    max_number_of_boxes_per_class=4,
    max_number_of_boxes_per_sample=10,
    boxes_iou_threshold=0.5,
    labels_probability_threshold=0.26,
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
def setup():
    """(Flax variables, the port's builder, its model with them, the JAX
    builder of the same configuration).  The variables are the port's init
    (Flax's distributions from a torch.Generator, quicker than the Flax
    init) with randomised BatchNorm."""
    builder = PortBuilder(**_builder_args())
    model = builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12),
                                           device="cpu")
    variables = randomize_batchnorm(to_flax_variables(model.state_dict()))
    model.load_state_dict(from_flax_variables(variables))
    jax_builder = JaxBuilder(**_builder_args())
    jax_builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12))
    return variables, builder, model, jax_builder


def _infer(setup, suppress_background_boxes=False, **kwargs):
    builder, model = setup[1:3]
    return builder.get_model_for_inference(
        model_trained=model, suppress_background_boxes=suppress_background_boxes,
        device="cpu", **NMS, **kwargs)


@pytest.fixture(scope="module")
def plain(setup, tmp_path_factory):
    """The JAX package's default serving (plain f32) as a b1 + b2 bundle."""
    infer = _infer(setup)
    path = str(tmp_path_factory.mktemp("bundles") / "plain")
    save_serving_bundle(infer, path, batch=(2, 1))
    return infer, path, load_serving_bundle(path)


@pytest.fixture(scope="module")
def fused(setup, tmp_path_factory):
    """Fused bf16 serving, bf16 mask, the background filter on: a b2 bundle."""
    infer = _infer(setup, suppress_background_boxes=True, compute_dtype="bfloat16",
                   fused_backbone=True, mask_output="bfloat16")
    path = str(tmp_path_factory.mktemp("bundles") / "fused")
    infer.export_serving_bundle(path, batch=2)
    return infer, path, load_serving_bundle(path)


def _uint8(batch, seed=1):
    return images(seed, (batch, 96, 128, 3), np.uint8)


def _assert_same_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_bundle_roundtrip_bit_exact(plain):
    infer, _, bundle = plain
    x = _uint8(2)
    _assert_same_bits(bundle(x), infer(x))
    mask, det = bundle.predict(x)
    assert mask.dtype == np.float32
    np.testing.assert_array_equal(det, infer(x)[1].numpy())


def test_bundle_bf16_operands_roundtrip(fused):
    infer, _, bundle = fused
    x = _uint8(2)
    mask, det = bundle(x)
    assert mask.dtype == torch.bfloat16
    _assert_same_bits((mask, det), infer(x))
    weights = bundle._operands["network"]
    assert weights["backbone-block2-mbconv"][0].dtype == torch.bfloat16


def test_bundle_predict_applies_background_filter(fused):
    infer, _, bundle = fused
    assert bundle.metadata["suppress_background_boxes"] is True
    x = _uint8(2)
    mask_live, det_live = infer.predict(x)
    mask_b, det_b = bundle.predict(x)
    np.testing.assert_array_equal(mask_b, mask_live)
    np.testing.assert_array_equal(det_b, det_live)
    assert det_b.ndim == 2 and det_b.shape[1] == 6 and len(det_b) > 0
    assert (det_b[:, 0] > 0.0).all()


def test_bundle_predict_batched_any_n(fused):
    """The single-batch bundle serves any N through its one baked size:
    chunk, repeat-pad, slice."""
    _, _, bundle = fused
    x = _uint8(5)
    mask, det = bundle.predict_batched(x)  # the background filter flattens det
    assert mask.shape[0] == 5
    m01, d01 = bundle.predict(x[0:2])
    np.testing.assert_array_equal(mask[0:2], m01)
    mask_p, det_p = bundle.predict(np.concatenate([x[4:5], x[4:5]]))
    np.testing.assert_array_equal(mask[4:5], mask_p[:1])
    assert len(det) >= len(d01)
    with pytest.raises(ValueError, match="empty"):
        bundle.predict_batched(x[:0])
    with pytest.raises(ValueError, match=r"\(N, H, W, C\)"):
        bundle.predict_batched(x[0])


def test_bundle_multi_batch_programs(plain):
    """One program per baked size sharing one stored operand set; each size
    exact; predict_batched routes to the largest program that fits."""
    infer, path, bundle = plain
    assert sorted(os.listdir(path)) == ["metadata.json", "operands.pt", "program_b1.pt2",
                                        "program_b2.pt2"]
    assert bundle.batches == [1, 2]
    x = _uint8(5)
    for b in (1, 2):
        _assert_same_bits(bundle(x[:b]), infer(x[:b]))
    mask, det = bundle.predict_batched(x)  # 2 + 2 + 1, no padded rows
    assert mask.shape[0] == 5 and det.shape[0] == 5
    m_tail, d_tail = bundle.predict(x[4:5])
    np.testing.assert_array_equal(mask[4:5], m_tail)
    np.testing.assert_array_equal(det[4:5], d_tail)
    with pytest.raises(ValueError, match=r"1\|2"):
        bundle(x[:3])


@pytest.mark.parametrize("sizes", [(1, 2), (16,), (16, 1), (2, 16), (1, 4, 16), (3, 5)])
def test_plan_batched_chunks_equals_the_jax_function(sizes):
    for n in range(1, 40):
        assert plan_batched_chunks(n, sizes) == jax_serving.plan_batched_chunks(n, sizes)
    with pytest.raises(ValueError):
        plan_batched_chunks(0, (1,))
    with pytest.raises(ValueError):
        plan_batched_chunks(4, ())


def test_bundle_nms_retune_without_reexport(plain):
    infer, _, bundle = plain
    x = _uint8(2)
    _, det_default = bundle(x)
    infer.set_nms_operating_point(boxes_iou_threshold=0.1, labels_probability_threshold=0.7)
    bundle.set_nms_operating_point(boxes_iou_threshold=0.1, labels_probability_threshold=0.7)
    try:
        _, det_live = infer(x)
        _, det_b = bundle(x)
    finally:
        for m in (infer, bundle):
            m.set_nms_operating_point(NMS["boxes_iou_threshold"],
                                      NMS["labels_probability_threshold"])
    assert torch.equal(det_b, det_live)
    assert (det_b[..., 1] > 0).sum() < (det_default[..., 1] > 0).sum()


def test_bundle_shape_guard(plain):
    _, _, bundle = plain
    with pytest.raises(ValueError, match="exported for images of shape"):
        bundle(_uint8(3))
    with pytest.raises(ValueError, match="exported for images of shape"):
        bundle(images(1, (2, 96, 120, 3), np.uint8))


def test_bundle_metadata(fused, plain):
    _, path, bundle = fused
    assert sorted(os.listdir(path)) == ["metadata.json", "operands.pt", "program.pt2"]
    meta = bundle.metadata
    assert meta["format_version"] == 1
    assert meta["batch"] == 2 and meta["batches"] == [2]
    assert meta["image_shape"] == [2, 96, 128, 3] and meta["image_dtype"] == "uint8"
    assert meta["device_type"] == "cpu" and meta["torch_version"] == torch.__version__
    assert meta["mask_output"] == "bfloat16" and meta["compute_dtype"] == "bfloat16"
    assert meta["fused_backbone"] is True
    assert meta["default_iou_threshold"] == pytest.approx(0.5)
    assert meta["default_score_threshold"] == pytest.approx(0.26)
    assert plain[2].metadata["batch"] == 2 and plain[2].metadata["fused_backbone"] is False


def test_bundle_refuses_another_device_type(plain):
    _, path, _ = plain
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        load_serving_bundle(path, device="cuda")


def test_loading_imports_no_model_building_module(plain):
    _, path, _ = plain
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import ssdseglib_torch.export as export\n"
        f"bundle = export.load_serving_bundle({path!r})\n"
        "x = np.random.default_rng(0).integers(0, 256, (1, 96, 128, 3), dtype=np.uint8)\n"
        "mask, det = bundle.predict(x)\n"
        "assert mask.shape == (1, 96, 128, 4) and det.shape == (1, 10, 6)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('ssdseglib_torch.models',\n"
        "    'ssdseglib_torch.layers', 'ssdseglib_torch.blocks', 'ssdseglib_torch.datacoder',\n"
        "    'ssdseglib_torch.train', 'ssdseglib_torch.keras_import'))\n"
        "    or m.split('.')[0] in ('jax', 'flax', 'ssdseglib_tpu'))\n"
        "print(json.dumps(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _op_nodes(path: str, filename: str):
    graph = torch.export.load(os.path.join(path, filename)).graph
    return [str(n.target) for n in graph.nodes if str(n.target).startswith("ssdseglib.")]


def test_the_fused_program_holds_the_mbconv_op(fused, plain):
    # and, in bf16, the 21 depthwise 3x3 convs' op (ops/depthwise3x3.py)
    ops = _op_nodes(fused[1], "program.pt2")
    assert sorted(set(ops)) == ["ssdseglib.depthwise3x3.default",
                                "ssdseglib.fused_mbconv.default"]
    assert ops.count("ssdseglib.fused_mbconv.default") == 10
    assert ops.count("ssdseglib.depthwise3x3.default") == 21
    assert _op_nodes(plain[1], "program_b1.pt2") == []  # plain: cuDNN/ATen only


def test_bundle_matches_the_jax_inference_model(setup, plain):
    """The reloaded plain f32 bundle against the JAX package's default
    `InferenceModel` on the same weights, at `test_torch_serving.py`'s
    tolerance (mask 2e-3, detection labels and row order exact, the rest
    1e-4)."""
    variables, _, _, jax_builder = setup
    jax_model = jax_builder.get_model_for_inference(
        model_trained=variables, suppress_background_boxes=False, **NMS)
    x = _uint8(2, seed=4)
    mask_j, det_j = jax_model.predict(x)
    mask, det = plain[2].predict(x)
    assert (det[..., 1] > 0).sum() >= 4
    np.testing.assert_allclose(mask, mask_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(det[..., 0], det_j[..., 0])
    np.testing.assert_allclose(det[..., 1:], det_j[..., 1:], rtol=1e-4, atol=1e-4)


def test_update_variables_swaps_weights_and_refuses_the_fused_path(setup):
    builder, model = setup[1:3]
    infer = _infer(setup)
    other = builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12),
                                           generator=torch.Generator().manual_seed(5),
                                           device="cpu")
    x = _uint8(2)
    before = infer(x)
    infer.update_variables(other.state_dict())
    _assert_same_bits(infer(x), _infer((None, builder, other))(x))
    infer.update_variables(model.state_dict())
    _assert_same_bits(infer(x), before)
    with pytest.raises(ValueError, match="fused_backbone=True"):
        _infer(setup, fused_backbone=True).update_variables(model.state_dict())


def _opcheck_cases():
    rng = np.random.default_rng(7)

    def t(*shape, scale=0.3):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    mbconv = (t(2, 5, 6, 16), t(16, 32), t(32), t(9, 32), t(32), t(32, 16), t(16), True)
    stem = (t(2, 8, 12, 3), [t(*shape) for pair in (
        ((27, 32), (32,)), ((9, 32), (32,)), ((32, 16), (16,)), ((16, 96), (96,)),
        ((9, 96), (96,)), ((96, 24), (24,))) for shape in pair])
    iou = torch.from_numpy(rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32))
    scan = (iou, torch.from_numpy(rng.uniform(0, 1, (2, 3, 8)) > 0.3),
            torch.tensor(0.5), 4)
    return [("fused_mbconv", mbconv), ("fused_stem_block1", stem), ("greedy_select", scan)]


@pytest.mark.parametrize("name, args", _opcheck_cases(), ids=lambda v: v if isinstance(
    v, str) else "")
def test_dispatcher_ops_pass_opcheck(name, args):
    import ssdseglib_torch.export  # noqa: F401  (registers the three ops)

    torch.library.opcheck(getattr(torch.ops.ssdseglib, name).default, args)


def test_option_forward_exports_with_its_ops(setup):
    """The option path (stem + block 1 kernel, top-K NMS with the scan
    kernel) captured by ``torch.export``: its graph calls the three ops and
    runs to the eager path's bits."""
    from ssdseglib_torch.config import NmsConfig
    from ssdseglib_torch.layers import SegmentationSuppression
    from ssdseglib_torch.models.fused_inference import fused_forward, fused_operands
    from ssdseglib_torch.ops.encoding import decode_predictions_to_corners_yx
    from ssdseglib_torch.ops.nms import combined_nms

    builder, model = setup[1:3]
    cfg = model.cfg
    operands = fused_operands(cfg, model.state_dict(), torch.float32, "cpu", s2d_stem="cuda")
    anchors = torch.stack([torch.from_numpy(a) for a in builder._anchors_centroids], -1)
    nms_cfg = NmsConfig(max_boxes_per_class=4, max_boxes_per_sample=10,
                        max_candidates_per_class=64)

    class Option(torch.nn.Module):
        def forward(self, operands, images, anchors, iou_threshold, score_threshold):
            out = fused_forward(cfg, operands, images, s2d_stem="cuda")
            labels = SegmentationSuppression()(out["output-mask"], out["output-labels"])
            boxes = decode_predictions_to_corners_yx(out["output-boxes"], anchors,
                                                     builder._stds)
            return combined_nms(boxes, labels, nms_cfg, method="topk",
                                iou_threshold=iou_threshold, score_threshold=score_threshold)

    args = (operands, torch.from_numpy(_uint8(2)), anchors, torch.tensor(0.5),
            torch.tensor(0.26))
    with torch.no_grad():
        exported = torch.export.export(Option(), args)
        want = Option()(*args)
    ops = [str(n.target) for n in exported.graph.nodes
           if str(n.target).startswith("ssdseglib.")]
    assert ops == (["ssdseglib.fused_stem_block1.default"]
                   + ["ssdseglib.fused_mbconv.default"] * 10
                   + ["ssdseglib.greedy_select.default"])
    got = exported.module()(*args)
    assert (want["valid"] > 0).all()
    for key in want:
        assert torch.equal(got[key], want[key]), key
