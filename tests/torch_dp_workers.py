"""Rank side of tests/test_torch_parallel.py: the port's data-parallel paths on
two gloo ranks on the CPU.  Imports nothing of JAX, so that the spawned
workers start quickly; the test process prepares the inputs, runs the
single-process and JAX references, and compares.

`run(rank, world, directory)` is the worker: it joins a gloo group on a
``file://`` store in ``directory``, reads ``inputs.pt`` there, runs every
case of `CASES` on a ``("data",)`` mesh and writes its results to
``rank{rank}.pt``.  A case returns tensors and numbers only.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ssdseglib_torch import layers
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.checkpoint import Checkpointer
from ssdseglib_torch.config import AnchorsConfig, EncodingConfig, ModelConfig, TrainConfig
from ssdseglib_torch.data.pipeline import TrainDataLoader
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.losses import confidence_loss
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder, SsdSegModel
from ssdseglib_torch.ops import fused_chain_backward as chain
from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.train import Trainer

# the JAX package's reduced model of its mesh tests (96x128,
# tests/test_multidevice_inference.py) with the anchors of the port's step
# tests (tests/test_torch_train.py)
IMAGE_SHAPE = (96, 128)
BATCH = 4  # global: two ranks of 2
ANCHORS = dict(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)
MODEL = dict(
    input_image_shape=(96, 128, 3),
    number_of_classes=4,
    boxes_per_point=(4, 4, 4, 4),
    backbone="mobilenetv2",
    segmentation_dilation_rates=(3, 6, 12),
)
SHUFFLENET = dict(MODEL, backbone="shufflenetv2", shufflenet_size="0.5x",
                  shufflenet_extra_depthwise=False, shufflenet_residuals=False)
ENCODING = dict(num_classes=4, image_shape=IMAGE_SHAPE, iou_threshold=0.35,
                max_ground_truth_boxes=16)
TRAIN = dict(batch_size=BATCH, learning_rate=3e-4, epochs=1)
FIT_SAMPLES, FIT_SEED = 16, 3
SERVE = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
             boxes_iou_threshold=0.5, labels_probability_threshold=0.05,
             suppress_background_boxes=False, use_segmentation_suppression=True)


def anchors() -> Anchors:
    return Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)


def trainer(model=MODEL, **overrides) -> Trainer:
    model = SsdSegModel(ModelConfig(**model), torch.Generator().manual_seed(0))
    return Trainer(model=model, anchors=anchors(), config=TrainConfig(**{**TRAIN, **overrides}),
                   device="cpu")


def loader(mesh=None) -> TrainDataLoader:
    samples = generate_dataset(FIT_SAMPLES, image_shape=IMAGE_SHAPE, seed=FIT_SEED)
    return TrainDataLoader(samples, anchors(), EncodingConfig(**ENCODING), batch_size=BATCH,
                           augmentation_horizontal_flip=True, augmentation_rgb=True, seed=0,
                           num_workers=2, device="cpu", mesh=mesh)


def builder() -> MobileNetV2SsdSegBuilder:
    centroids = anchors().centroids
    return MobileNetV2SsdSegBuilder(
        MODEL["input_image_shape"], 4, 4, centroids[:, 0], centroids[:, 1], centroids[:, 2],
        centroids[:, 3], (0.1, 0.1, 0.2, 0.2))


def inference_model(variables, mesh=None, fused=False, **options):
    """The serving model of ``variables`` (a ``state_dict``) on the CPU;
    ``options`` go to `get_model_for_inference`."""
    model = SsdSegModel(ModelConfig(**MODEL), torch.Generator().manual_seed(0))
    model.load_state_dict(variables)
    return builder().get_model_for_inference(model, device="cpu", mesh=mesh,
                                             fused_backbone=fused, **SERVE, **options)


def int8_tables(infer) -> dict:
    """The int8 tables among a quantized model's operands."""
    return {name: [t.clone() for t in tables]
            for name, tables in infer._operands["network"].items() if name.endswith("/int8")}


def step_results(state, metrics) -> dict:
    """What the test compares of one step: metrics, the gradient (Adam's
    first moment after one step is 0.1 * g), parameters and statistics."""
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: v.float() * 10.0 for k, v in state.opt_state.mu.items()},
        "params": {k: v.clone() for k, v in state.params.items()},
        "batch_stats": {k: v.clone() for k, v in state.batch_stats.items()},
    }


def one_step(mesh, variables, images, targets, **overrides):
    t = trainer(**overrides)
    state = t.init_state(variables=variables, mesh=mesh)
    if mesh is not None:
        images, targets = mesh_lib.shard_batch(mesh, (images, targets))
    return step_results(*t.train_step(state, images, targets))


def chain_anywhere(h, w, c, kernel_size, strides, dilation, relu_max):
    """`chain_applicable` without its size heuristic, so that the reduced
    model's depthwise layers take the chain unit on the CPU too."""
    return (tuple(kernel_size) == (3, 3) and tuple(strides) == (1, 1)
            and tuple(dilation) == (1, 1) and relu_max == 6.0 and c <= 64)


class _Patch:
    """Sets attributes for the length of a ``with`` block."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name, _ in self.triples]
        for obj, name, value in self.triples:
            setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def case_helpers(mesh, inputs, directory):
    rank = dist.get_rank()
    out = {"slice": mesh_lib.shard_batch(mesh, {"a": np.arange(8), "b": [torch.arange(4)]})}
    try:
        mesh_lib.shard_batch(mesh, np.zeros((3, 4, 4, 3), np.float32))
    except ValueError as e:
        out["divisibility"] = str(e)
    mine = {"f32": torch.full((2, 3), float(rank + 1)), "bf16": torch.full((5,), rank + 1.5,
            dtype=torch.bfloat16), "i64": [torch.arange(3) * (rank + 1)],
            "nhwc": torch.full((2, 3, 4, 5), float(rank)).contiguous(
                memory_format=torch.channels_last)}
    out["replicated"] = mesh_lib.replicate(mesh, mine)
    out["placements"] = (repr(mesh_lib.batch_sharding(mesh)),
                         repr(mesh_lib.replicate_sharding(mesh)))
    from torch.distributed.device_mesh import init_device_mesh

    # axes that are neither ("data",) nor ("data", "spatial")
    axes = init_device_mesh("cpu", (2, 1), mesh_dim_names=("spatial", "data"))
    refusals = {}
    for name, call in (
            ("shard_images", lambda m: mesh_lib.shard_images(m, np.zeros((4, 2, 2, 3)))),
            ("fit", lambda m: trainer().fit(None, [], epochs=1, mesh=m)),
            ("loader", lambda m: loader(m)),
            ("inference", lambda m: inference_model(inputs["variables"], m))):
        for kind, m in (("axes", axes), ("object", object())):
            try:
                call(m)
                refusals[name, kind] = None
            except (TypeError, ValueError) as e:
                refusals[name, kind] = type(e).__name__
    out["refusals"] = refusals
    return out


def case_steps(mesh, inputs, directory):
    """One step of each route on the mesh; the cuda gates' route with the
    chain unit on every in-envelope depthwise layer (`chain_anywhere`), whose
    backward must take the split path."""
    images, targets = inputs["batch"]
    out = {"aten": one_step(mesh, inputs["variables"], images, targets)}
    split_calls = []
    backward = chain.dw_bn_relu6_backward

    def spy(*args):
        split_calls.append(len(args) > 9 and args[9] is not None)
        return backward(*args)

    with _Patch((chain, "chain_applicable", chain_anywhere),
                (chain, "dw_bn_relu6_backward", spy)):
        for gate in (blocks.set_chain_bwd_impl, blocks.set_depthwise_bwd_impl,
                     blocks.set_wgrad_impl):
            gate("cuda")
        try:
            out["cuda"] = one_step(mesh, inputs["variables"], images, targets)
        finally:
            for gate in (blocks.set_chain_bwd_impl, blocks.set_depthwise_bwd_impl,
                         blocks.set_wgrad_impl):
                gate("aten")
    out["split_calls"] = split_calls
    return out


def case_global_batchnorm(mesh, inputs, directory):
    """The step on a batch whose halves have different means, with the
    global statistics and, as a naive port would, with per-rank ones."""
    images, targets = inputs["shifted"]
    out = {"global": one_step(mesh, inputs["variables"], images, targets)}
    with _Patch((blocks, "active_groups", lambda: None)):
        out["per_rank"] = one_step(mesh, inputs["variables"], images, targets)
    return out


def case_hard_negatives(mesh, inputs, directory):
    out = {}
    for name, (y_true, y_pred) in inputs["hnm"].items():
        local_true, local_pred = mesh_lib.shard_batch(mesh, (y_true, y_pred))
        with mesh_lib.data_parallel(mesh):
            out[name, "global"] = confidence_loss(local_true, local_pred)
        out[name, "per_rank"] = confidence_loss(local_true, local_pred)
    return out


def case_serving(mesh, inputs, directory):
    images = inputs["serve_images"]
    out = {}
    for fused in (False, True):
        infer = inference_model(inputs["variables"], mesh, fused)
        out["predict", fused] = infer.predict(images)
        out["batched", fused] = infer.predict_batched(images[:6], batch=4)
        out["call", fused] = tuple(t.clone() for t in infer(images))
    # a class present only in rank 1's slice of the batch: the suppression
    # must keep it in rank 0's labels too
    mask, labels = mesh_lib.shard_batch(mesh, inputs["suppression"])
    with mesh_lib.data_parallel(mesh):
        out["gated"] = layers.SegmentationSuppression()(mask, labels)
    out["gated_per_rank"] = layers.SegmentationSuppression()(mask, labels)
    try:
        infer.export_serving_bundle(os.path.join(directory, "bundle"), batch=4)
    except ValueError as e:
        out["export"] = str(e)
    # new weights that differ between the ranks: rank 0's are loaded on both
    infer = inference_model(inputs["variables"], mesh)
    mine = {k: v * (1.0 + 0.1 * dist.get_rank()) if v.is_floating_point() else v
            for k, v in inputs["variables"].items()}
    infer.update_variables(mine)
    out["updated"] = infer.predict(images)
    # int8 serving: every rank calibrates on the whole batch
    infer = inference_model(inputs["variables"], mesh, True, quantize_pointwise=True,
                            calibration_images=images)
    out["quantized"] = infer.predict(images), int8_tables(infer)
    return out


def case_fit(mesh, inputs, directory):
    t = trainer()
    state = t.init_state(variables=inputs["variables"], mesh=mesh)
    state, history = t.fit(state, loader(mesh), epochs=2, validation_data=loader(mesh),
                           mesh=mesh, log_fn=lambda s: None)
    out = {"history": history, "params": state.params, "step": state.step}

    # checkpoint under the mesh (rank 0 writes), then a fresh trainer resumes
    writes = []
    write = Checkpointer._write

    def counted(self, step, state):
        writes.append(step)
        return write(self, step, state)

    ckpt_dir = os.path.join(directory, "ckpt")
    with _Patch((Checkpointer, "_write", counted)):
        t = trainer()
        state = t.init_state(torch.Generator().manual_seed(1), mesh=mesh)
        state, _ = t.fit(state, loader(mesh), epochs=1, mesh=mesh,
                         checkpointer=Checkpointer(ckpt_dir), log_fn=lambda s: None)
        saved = {"step": state.step, "params": {k: v.clone() for k, v in state.params.items()}}
        t = trainer()
        fresh = t.init_state(torch.Generator().manual_seed(99), mesh=mesh)
        resumed, history = t.fit(fresh, loader(mesh), epochs=1, mesh=mesh, resume=True,
                                 checkpointer=Checkpointer(ckpt_dir), log_fn=lambda s: None)
    out["checkpoint"] = {"writes": writes, "saved": saved, "resumed_step": resumed.step,
                         "resumed_params": resumed.params, "files": sorted(os.listdir(ckpt_dir)),
                         "resumed_loss": history["loss"][-1]}

    t = trainer(model=SHUFFLENET)
    state = t.init_state(torch.Generator().manual_seed(2), mesh=mesh)
    state, history = t.fit(state, loader(mesh), epochs=1, mesh=mesh, log_fn=lambda s: None)
    out["shufflenet"] = {"loss": history["loss"][0], "step": state.step,
                         "params": {k: state.params[k] for k in list(state.params)[:8]}}
    return out


def case_example(mesh, inputs, directory):
    """Notebook 03's learning run at a tiny size on the mesh, as
    ``--data-parallel`` under torchrun runs it."""
    from ssdseglib_torch.examples import train_multitask

    workdir = os.path.join(directory, f"example{dist.get_rank()}")
    os.makedirs(workdir)
    return train_multitask.run(**EXAMPLE, device="cpu", workdir=workdir, mesh=mesh,
                               log_fn=lambda line: None)


EXAMPLE = dict(epochs=1, train_samples=8, test_samples=4, batch_size=4, image_shape=(96, 128))

CASES = {
    "helpers": case_helpers,
    "steps": case_steps,
    "global_batchnorm": case_global_batchnorm,
    "hard_negatives": case_hard_negatives,
    "serving": case_serving,
    "fit": case_fit,
    "example": case_example,
}


def run(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        mesh = mesh_lib.make_mesh(device="cpu")
        results = {name: case(mesh, inputs, directory) for name, case in CASES.items()}
        torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
