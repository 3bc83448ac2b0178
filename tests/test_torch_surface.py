"""The port's package surface against the JAX package's (module lists, the
`blocks` aliases, `models` and `ops`), and notebook 03's learning-run module
end to end at a tiny size on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssdseglib_torch
import ssdseglib_tpu
from ssdseglib_tpu import blocks as jax_blocks
from ssdseglib_tpu import models as jax_models
from ssdseglib_tpu import ops as jax_ops
from ssdseglib_torch import blocks, models, ops, plot
from ssdseglib_torch.examples import train_multitask
from tests.torch_parity import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_surface_is_the_jax_package_s_less_the_named_missing():
    assert ssdseglib_torch.NOT_PORTED == ("parallel.spatial",)
    assert ssdseglib_torch.__all__ == ssdseglib_tpu.__all__
    for name in ssdseglib_torch.__all__:
        assert hasattr(ssdseglib_torch, name), name
    # the missing module's names are the ones the port's parallel lacks
    from ssdseglib_tpu.parallel import spatial

    jax_parallel, port_parallel = ssdseglib_tpu.parallel, ssdseglib_torch.parallel
    missing = [n for n in jax_parallel.__all__ if n not in port_parallel.__all__]
    assert missing == ["SPATIAL_AXIS", "make_hybrid_mesh", "image_sharding"]
    assert all(hasattr(spatial, n) for n in missing)
    assert port_parallel.__all__ == [n for n in jax_parallel.__all__ if n not in missing]


def test_importing_the_package_builds_and_loads_no_kernel():
    code = (
        "import sys, ssdseglib_torch\n"
        "from ssdseglib_torch.ops import _cuda_build\n"
        "assert _cuda_build._lib is None and _cuda_build.build_info is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'ssdseglib_tpu', 'triton', 'matplotlib')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_blocks_surface_and_reference_aliases():
    assert blocks.__all__ == jax_blocks.__all__
    assert blocks.deeplabv3plus_encoder is blocks.DeepLabV3PlusEncoder
    assert blocks.deeplabv3plus_decoder is blocks.DeepLabV3PlusDecoder
    assert blocks.ssdlite is blocks.SsdLiteBlock
    for name in blocks.__all__:
        assert getattr(blocks, name) is not None, name


def test_models_and_ops_surfaces():
    assert models.__all__ == jax_models.__all__
    assert ops.__all__ == jax_ops.__all__
    for name in ops.__all__:
        assert getattr(ops, name).__name__ == f"ssdseglib_torch.ops.{name}"
    assert models.TrainableModel is models.SsdSegModel


def test_the_model_for_training_is_the_trainable_model_with_parameter_counts():
    from ssdseglib_torch.config import reference_warehouse_config

    anchors_cfg, enc_cfg, model_cfg, _, _ = reference_warehouse_config()
    builder = models.MobileNetV2SsdSegBuilder(
        input_image_shape=model_cfg.input_image_shape,
        number_of_boxes_per_point=list(model_cfg.boxes_per_point),
        number_of_classes=4, center_x_boxes_default=[1.0], center_y_boxes_default=[1.0],
        width_boxes_default=[1.0], height_boxes_default=[1.0],
        standard_deviations_centroids_offsets=enc_cfg.standard_deviations)
    model = builder.get_model_for_training(
        segmentation_dilation_rates=model_cfg.segmentation_dilation_rates, device="cpu")
    assert isinstance(model, models.TrainableModel)
    # the reference's published counts (notebook 03 cell 5's summary)
    assert model.parameter_counts() == models.count_parameters(model) == (4009920, 37488)


def test_move_figure_leaves_a_windowless_figure_alone():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figure = plt.figure()
    try:
        plot.move_figure(figure, 10, 20)
    finally:
        plt.close(figure)


def test_learning_run_end_to_end_on_the_cpu(tmp_path):
    """Notebook 03's path (files -> DataEncoderDecoder -> loader -> fit ->
    both serving modes -> evaluators) at 96x128, 8 training samples in
    batches of 3 (the last one partial, as the notebook's), 2 epochs; no
    kernel is launched on the CPU."""
    lines = []
    result = train_multitask.run(epochs=2, train_samples=8, test_samples=4, batch_size=3,
                                 image_shape=(96, 128), compute_dtype="float32",
                                 device="cpu", workdir=str(tmp_path), log_fn=lines.append)
    assert result["train_samples"] == 8 and result["test_samples"] == 4
    assert result["steps_per_epoch"] == 3 and len(lines) == 3  # parameters, two epochs
    assert lines[1].startswith("epoch 1/2") and "3 steps" in lines[1]
    for serving in ("f32", "bf16_fused"):
        metrics = result["metrics"][serving]
        assert set(metrics) == {"mAP@0.5", "mAP@0.6", "mAP@0.7", "mIoU"}
        assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    assert np.isfinite([result["first_loss"], result["last_loss"]]).all()
    assert result["epoch_images_per_s"] > 0 and result["wall_seconds"] > 0
    assert set(result["kernel_launches"].values()) == {0}
    assert set(train_multitask.meets_limits(result)) == set(train_multitask.LIMITS)
    assert os.listdir(tmp_path) == []  # the files are removed
    json.dumps(result)


def test_training_set_is_the_notebook_s():
    """At the defaults (256 and 64) the training set is what the JAX
    package's verbatim notebook run trained on: 128 train, 51 additional
    persons (80% of 64), 64 additional forklifts and 16 of the evaluation
    split, 259 samples in 17 batches of 16 (the last of 3)."""
    counts = {name: (seed, count(256, 64)) for name, seed, count in train_multitask.TRAIN_SPLITS}
    assert counts == {"train": (11, 128), "train-additional-persons": (22, 51),
                      "train-additional-forklifts": (33, 64), "eval-persons-forklifts": (44, 16)}
    assert sum(n for _, n in counts.values()) == 259
    assert train_multitask.TEST_SEED == 55


def test_learning_run_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        train_multitask.main([])


def test_full_size_anchors_are_the_warehouse_configuration():
    from ssdseglib_torch.config import reference_warehouse_config

    assert train_multitask.anchors_config((480, 640)) == reference_warehouse_config()[0]
