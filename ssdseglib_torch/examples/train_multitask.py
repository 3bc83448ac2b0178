"""Notebook 03's learning run on the port: the reference multi-task recipe
(notebook `03-multi-task-network-ssdlite-deeplabv3plus-training`, as
`examples/03_train_multitask.py` runs it on the JAX package) from synthetic
PNG / CSV files to the evaluators.

    python -m ssdseglib_torch.examples.train_multitask \
        [--chain-bwd-impl {aten,cuda}] [--wgrad-impl {aten,dot,cuda}] \
        [--compute-dtype {float32,bfloat16}] [--seed N] [--output FILE]

    torchrun --nproc_per_node=N -m ssdseglib_torch.examples.train_multitask \
        --data-parallel [...]

The path, as a user of the reference takes it:
- data: notebook 03's training set of synthetic warehouse scenes without
  overlapping objects, written as (image.png, mask.png, boxes.csv) triples
  at the splits' seeds and counts as the JAX package's verbatim notebook run
  writes them (`examples/05_reference_notebook_unmodified.py`): train (seed
  11, half of ``train_samples``), 80% of the additional persons (seed 22, a
  quarter), the additional forklifts (seed 33, a quarter) and the
  persons-and-forklifts evaluation split (seed 44, a quarter of
  ``test_samples``) -- 259 samples at the defaults, as that run trained on;
  the test split is seed 55;
- `DataEncoderDecoder` with the warehouse anchors (it sets the encoding of
  the loader, and reads and encodes the test split on the device);
- `TrainDataLoader(batch_size=16, flip and rgb augmentation)`, keeping the
  last partial batch as the notebook's ``tf.data`` ``batch`` does (17 steps
  an epoch at the defaults);
- `reference_warehouse_config()`'s model through
  `MobileNetV2SsdSegBuilder.get_model_for_training`;
- `Trainer.fit`: Adam 1e-4, loss weights 1 / 1 / 1, cross-entropy mask loss
  with class weights (0.05, 0.575, 0.135, 0.24), seed 1993, 105 epochs
  (`TrainConfig`'s defaults are the recipe), in f32 as the notebook and the
  JAX package's run of it compute (``--compute-dtype bfloat16`` trains in the
  JAX package's mixed precision, whose model serves badly on its BatchNorm
  running statistics: ROADMAP.md, Queue 3);
- the evaluators at notebook 03's NMS operating point (IoU 0.025, score
  0.725, at most 4 boxes a class and 10 a sample, segmentation suppression):
  mAP at IoU 0.5, 0.6 and 0.7 and the soft mIoU, each the mean over the three
  object classes, through two serving modes: the unfused model in f32, and
  the BN-folded bf16 forward with the fused MBConv kernel.

The two backward-route gates of `models/blocks.py` choose where the
gradients of the layers inside the kernels' envelopes are computed: the
library (``aten``, the default) or the hand-written kernels (``cuda``).

``--data-parallel`` trains on the mesh of `parallel.make_mesh` over the
launcher's processes, one card each (the counterpart of the JAX example's
flag): the batch of 16 is the global batch, each rank decodes and trains on
its slice, and the loader drops the trailing partial batch (at the defaults
3 samples, which no mesh of 2 or more ranks can split evenly).  Every rank
evaluates the trained model alone; rank 0 prints and writes the result.

Prints the epoch lines, then one JSON line: the metrics of both serving
modes, the first and last epoch losses, the training images/s of an epoch,
the seconds taken, the kernels' launches, the card, and whether the run met
the limits written in `LIMITS`; exits 1 if it did not.  `run` takes smaller
sizes for tests.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# notebook 03's training set: (name, seed, its count from train_samples and
# test_samples).  The notebook keeps 80% of the additional persons (SURVEY.md,
# C24); which 80% its draw takes is not recorded, and the synthetic scenes are
# alike, so the first 80% are kept
TRAIN_SPLITS = (
    ("train", 11, lambda train, test: max(2, train // 2)),
    ("train-additional-persons", 22, lambda train, test: int(0.8 * max(1, train // 4))),
    ("train-additional-forklifts", 33, lambda train, test: max(1, train // 4)),
    ("eval-persons-forklifts", 44, lambda train, test: max(1, test // 4)),
)
TEST_SEED = 55
LABELS_CODES, LABEL_CODE_BACKGROUND = [0, 1, 2, 3], 0
IOU_THRESHOLDS = (0.5, 0.6, 0.7)
# what each route must reach on the recipe: the JAX package's marks on
# notebook 03 (mIoU 0.6824, mAP@0.5 0.4747, loss 19143.6 -> 74.39) less 0.05,
# a last loss below 150 after a fall of at least 100x, and the fused bf16
# serving within 0.01 of the f32 serving
LIMITS = dict(f32_miou=0.63, f32_map50=0.42, last_loss=150.0, loss_fall=100.0,
              bf16_vs_f32=0.01)


def write_split(directory: str, name: str, count: int, seed: int,
                image_shape: Tuple[int, int]) -> List[Tuple[str, str, str]]:
    """``count`` synthetic scenes of ``seed`` as (image.png, mask.png,
    boxes.csv) triples under ``directory``; the CSV rows are
    ``label,xmin,ymin,xmax,ymax`` in whole pixels, CRLF-terminated, as the
    reference's files are."""
    from PIL import Image

    from ssdseglib_torch.data.synthetic import generate_sample

    def write(i: int) -> Tuple[str, str, str]:
        s = generate_sample(i, image_shape=image_shape, seed=seed, non_overlapping=True)
        paths = tuple(os.path.join(directory, f"{name}-{i}-{kind}")
                      for kind in ("image.png", "mask.png", "boxes.csv"))
        Image.fromarray(s.image).save(paths[0])
        Image.fromarray(s.mask).save(paths[1])
        with open(paths[2], "w") as f:
            for label, (x0, y0, x1, y1) in zip(s.labels, s.boxes):
                f.write(f"{int(label)},{x0:.0f},{y0:.0f},{x1:.0f},{y1:.0f}\r\n")
        return paths

    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(write, range(count)))


def anchors_config(image_shape: Tuple[int, int]):
    """The warehouse anchors on the four feature maps of a model at
    ``image_shape`` (os16, os32, os64, os128; at 480x640 exactly
    `reference_warehouse_config()`'s)."""
    import dataclasses

    from ssdseglib_torch.config import reference_warehouse_config

    cfg = reference_warehouse_config()[0]
    h, w = image_shape
    shapes = tuple((-(-h // s), -(-w // s)) for s in (16, 32, 64, 128))
    return dataclasses.replace(cfg, feature_maps_shapes=shapes)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def evaluate(inference, images: np.ndarray, gt_boxes: List[str], gt_masks: List[str],
             batch_size: int) -> Dict[str, float]:
    """mAP at each of IOU_THRESHOLDS and the soft mIoU (means over the object
    classes) of ``inference``'s predictions on ``images``."""
    from ssdseglib_torch import evaluators

    masks, detections = inference.predict_batched(images, batch=batch_size)
    labels = detections[:, :, 0].astype(np.int32)
    result = {}
    for thr in IOU_THRESHOLDS:
        ap = evaluators.average_precision_object_detection(
            labels, detections[:, :, 1], detections[:, :, 2:], thr, gt_boxes,
            labels_codes=LABELS_CODES, label_code_background=LABEL_CODE_BACKGROUND)
        result[f"mAP@{thr}"] = float(np.mean(list(ap.values())))
    iou = evaluators.jaccard_iou_semantic_segmentation(
        masks, gt_masks, labels_codes=LABELS_CODES, label_code_background=LABEL_CODE_BACKGROUND)
    result["mIoU"] = float(np.mean(list(iou.values())))
    return result


def run(epochs: int = 105, train_samples: int = 256, test_samples: int = 64,
        batch_size: int = 16, image_shape: Tuple[int, int] = (480, 640),
        chain_bwd_impl: str = "aten", wgrad_impl: str = "aten",
        compute_dtype: str = "float32", seed: int = 1993,
        device="cuda", workdir: Optional[str] = None, log_fn=print, mesh=None) -> dict:
    """Notebook 03's recipe end to end (the module docstring); returns the
    result that `main` prints.  ``seed`` draws the initial weights and the
    loader's shuffle and augmentation (the data's seeds are TRAIN_SPLITS').
    ``device`` is the card unless the caller asks for the CPU.  With a
    ``mesh`` (`parallel.make_mesh`) the training is data-parallel over it."""
    from ssdseglib_torch.config import TrainConfig, reference_warehouse_config
    from ssdseglib_torch.data.pipeline import TrainDataLoader
    from ssdseglib_torch.datacoder import DataEncoderDecoder
    from ssdseglib_torch.models import MobileNetV2SsdSegBuilder, blocks
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.ops import fused_chain_backward, fused_mbconv, pointwise_wgrad
    from ssdseglib_torch.train import Trainer

    t_start = time.perf_counter()
    _, enc_cfg, model_cfg, nms_cfg, _ = reference_warehouse_config()
    anchors = Anchors.from_config(anchors_config(image_shape), image_shape)
    config = TrainConfig(batch_size=batch_size, epochs=epochs, compute_dtype=compute_dtype,
                         seed=seed)
    with tempfile.TemporaryDirectory(prefix="notebook03_", dir=workdir) as directory:
        train = [t for name, split_seed, count in TRAIN_SPLITS
                 for t in write_split(directory, name, count(train_samples, test_samples),
                                      split_seed, image_shape)]
        test = write_split(directory, "test", test_samples, TEST_SEED, image_shape)
        coder = DataEncoderDecoder(
            num_classes=enc_cfg.num_classes, image_shape=image_shape,
            center_x_boxes_default=anchors.center_x, center_y_boxes_default=anchors.center_y,
            width_boxes_default=anchors.width, height_boxes_default=anchors.height,
            iou_threshold=enc_cfg.iou_threshold,
            standard_deviations_centroids_offsets=enc_cfg.standard_deviations, device=device)
        loader = TrainDataLoader(train, coder.anchors, coder.config, batch_size=batch_size,
                                 augmentation_horizontal_flip=True, augmentation_rgb=True,
                                 drop_remainder=mesh is not None, seed=config.seed,
                                 device=device, mesh=mesh)
        builder = MobileNetV2SsdSegBuilder(
            input_image_shape=tuple(image_shape) + (3,),
            number_of_boxes_per_point=list(model_cfg.boxes_per_point),
            number_of_classes=model_cfg.number_of_classes,
            center_x_boxes_default=anchors.center_x, center_y_boxes_default=anchors.center_y,
            width_boxes_default=anchors.width, height_boxes_default=anchors.height,
            standard_deviations_centroids_offsets=enc_cfg.standard_deviations)
        model = builder.get_model_for_training(
            segmentation_dilation_rates=model_cfg.segmentation_dilation_rates,
            generator=torch.Generator().manual_seed(config.seed), device=device)
        trainer = Trainer(model=model, anchors=coder.anchors, config=config,
                          standard_deviations=enc_cfg.standard_deviations, device=device)
        state = trainer.init_state(variables=model.state_dict(), mesh=mesh)
        trainable, stats = model.parameter_counts()
        log_fn(f"params: {trainable + stats:,} total / {trainable:,} trainable")

        counters = {"chain_backward": fused_chain_backward.dw_bn_relu6_backward,
                    "wgrad_mma": pointwise_wgrad.wgrad_mma,
                    "wgrad_fma": pointwise_wgrad.wgrad_fma, "fused_mbconv": fused_mbconv.fused_mbconv}
        for counter in counters.values():
            counter.launches = 0
        marks = []

        def log_epoch(line: str) -> None:
            marks.append(time.perf_counter())
            log_fn(line)

        gates = (blocks.CHAIN_BWD_IMPL, blocks.WGRAD_IMPL)
        blocks.set_chain_bwd_impl(chain_bwd_impl)
        blocks.set_wgrad_impl(wgrad_impl)
        try:
            t_fit = time.perf_counter()
            state, history = trainer.fit(state, loader, epochs=epochs, log_fn=log_epoch,
                                         mesh=mesh)
            train_seconds = time.perf_counter() - t_fit
        finally:
            blocks.set_chain_bwd_impl(gates[0])
            blocks.set_wgrad_impl(gates[1])

        missing, unexpected = model.load_state_dict(state.variables(), strict=False)
        if unexpected or not all(k.endswith("num_batches_tracked") for k in missing):
            raise RuntimeError(f"trained state does not fit the model: {missing} {unexpected}")
        encoded = [coder.read_and_encode(*t) for t in test]
        images = np.stack([image for image, _ in encoded])
        gt_boxes, gt_masks = [t[2] for t in test], [t[1] for t in test]
        nms = dict(
            max_number_of_boxes_per_class=nms_cfg.max_boxes_per_class,
            max_number_of_boxes_per_sample=nms_cfg.max_boxes_per_sample,
            boxes_iou_threshold=nms_cfg.iou_threshold,
            labels_probability_threshold=nms_cfg.score_threshold,
            suppress_background_boxes=nms_cfg.suppress_background_boxes,
            use_segmentation_suppression=nms_cfg.use_segmentation_suppression)
        serving = {
            "f32": builder.get_model_for_inference(model_trained=model, device=device, **nms),
            "bf16_fused": builder.get_model_for_inference(
                model_trained=model, compute_dtype="bfloat16", fused_backbone=True,
                mask_output="bfloat16", device=device, **nms),
        }
        metrics = {name: evaluate(inference, images, gt_boxes, gt_masks, batch_size)
                   for name, inference in serving.items()}

    steps = len(loader)
    epoch_seconds = np.diff([t_fit] + marks)
    steady = epoch_seconds[1:] if len(epoch_seconds) > 1 else epoch_seconds
    losses = history["loss"]
    return {
        "route": {"chain_bwd_impl": chain_bwd_impl, "wgrad_impl": wgrad_impl},
        "compute_dtype": compute_dtype,
        "epochs": epochs, "train_samples": len(train), "test_samples": len(test),
        "steps_per_epoch": steps, "image_shape": list(image_shape),
        "seed": seed, "metrics": metrics,
        "world_size": 1 if mesh is None else mesh.size(),
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_fall": losses[0] / losses[-1],
        "first_epoch_seconds": float(epoch_seconds[0]),
        "epoch_images_per_s": float(steps * batch_size / statistics.median(steady)),
        "train_seconds": train_seconds,
        "wall_seconds": time.perf_counter() - t_start,
        "kernel_launches": {name: c.launches for name, c in counters.items()},
    }


def meets_limits(result: dict) -> Dict[str, bool]:
    """Each of LIMITS against a result of `run`."""
    f32, bf16 = result["metrics"]["f32"], result["metrics"]["bf16_fused"]
    return {
        "f32_miou": f32["mIoU"] >= LIMITS["f32_miou"],
        "f32_map50": f32["mAP@0.5"] >= LIMITS["f32_map50"],
        "last_loss": result["last_loss"] <= LIMITS["last_loss"],
        "loss_fall": result["loss_fall"] >= LIMITS["loss_fall"],
        "bf16_vs_f32": max(abs(bf16[k] - f32[k]) for k in ("mIoU", "mAP@0.5"))
        <= LIMITS["bf16_vs_f32"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chain-bwd-impl", choices=("aten", "cuda"), default="aten")
    parser.add_argument("--wgrad-impl", choices=("aten", "dot", "cuda"), default="aten")
    parser.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--seed", type=int, default=1993,
                        help="initial weights, shuffle and augmentation (the recipe's: 1993)")
    parser.add_argument("--output", help="also write the JSON line to this file")
    parser.add_argument("--data-parallel", action="store_true",
                        help="train on a data mesh over the launcher's processes "
                             "(torchrun --nproc_per_node=N), one card each")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the learning run needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, lead = None, True
    if args.data_parallel:
        import torch.distributed as dist

        from ssdseglib_torch.parallel import make_mesh

        mesh = make_mesh()
        lead = dist.get_rank() == 0
    try:
        result = run(chain_bwd_impl=args.chain_bwd_impl, wgrad_impl=args.wgrad_impl,
                     compute_dtype=args.compute_dtype, seed=args.seed, mesh=mesh,
                     log_fn=print if lead else (lambda line: None))
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if not lead:
        return 0
    result["card"] = card()
    result["limits"] = LIMITS
    result["meets_limits"] = checks = meets_limits(result)
    line = json.dumps(result)
    print(line, flush=True)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
