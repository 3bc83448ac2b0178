"""Long-horizon detection learning on synthetic scenes, then the NMS
operating-point grid search: `examples/04_detection_learning.py` on the
port.

    python -m ssdseglib_torch.examples.detection_learning [--steps 12000] \
        [--f32] [--precise-bn N] [--checkpoint-dir DIR [--resume]] \
        [--log-file FILE] [--output FILE] [the JAX driver's other flags]

The reference's published detection result (mAP@0.5 = 0.53, notebook 03
cell 29) took 23.7k steps at lr 1e-4 and a post-training search of the NMS
operating point (cells 21-23).  This driver runs the same capability on the
synthetic warehouse scenes with the JAX driver's flags and defaults: a
warmup-cosine schedule (peak 2.5e-4, 500 warmup steps, final peak / 20),
seed 1993, bf16 mixed precision unless ``--f32``, the reference's hard
negative mining (``--hnm-ratio 3``), clean non-overlapping scenes unless
``--occluded-scenes``, evaluation every ``--eval-every`` steps (mAP@{0.5,
0.6, 0.7} and the soft mIoU, optionally on PreciseBN statistics over
``--precise-bn`` training batches), checkpoints at the evaluations and
``--resume`` from the latest, a JSONL ``--log-file`` (`MetricsLogger`).

Every raw training batch is uploaded to the card once; each step runs the
loader's device transform (flip, colour, anchor matching) and the train
step as one fused call (`Trainer.fused_train_step_fn`) on a
``torch.Generator`` reseeded from the step, so a step moves nothing from
the host.  Evaluation serves through one unfused `InferenceModel` whose
weights are swapped in place (`update_variables`).  After training, the raw
outputs of the evaluation scenes (`InferenceModel.raw_outputs`) go through
`nms_grid_search`, the port's `NonMaximumSuppression` on the card at every
(IoU, probability) point of the reference grid; the best point's detections
give the final mAP@{0.5, 0.6, 0.7} and mIoU.

Prints the step and evaluation lines, the grid, then one JSON line; `run`
returns the same result and takes smaller sizes for tests.  The trajectory
is this port's: its random streams are PyTorch's, not JAX's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

LABELS_CODES, LABEL_CODE_BACKGROUND = [0, 1, 2, 3], 0
IOU_THRESHOLDS = (0.5, 0.6, 0.7)
# the reference's grid (notebook 03 cells 21-23)
IOU_GRID = (0.025, 0.1, 0.2, 0.35, 0.5)
PROB_GRID = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
# seeds: the scenes (training, evaluation), the step generator's base and the
# PreciseBN batches' generator, as the JAX driver's keys
TRAIN_SCENES_SEED, EVAL_SCENES_SEED, STEP_SEED, PRECISE_BN_SEED = 1993, 2024, 7, 4242


def evaluate(labels_pred, conf_pred, boxes_pred, masks_pred, gt, gt_masks) -> dict:
    """mAP@{.5,.6,.7} (with the per-class APs) and the soft mIoU, the
    reference's evaluators, means over the object classes."""
    from ssdseglib_torch import evaluators

    out = {}
    for thr in IOU_THRESHOLDS:
        ap = evaluators.average_precision_object_detection(
            labels_pred, conf_pred, boxes_pred, thr, gt,
            labels_codes=LABELS_CODES, label_code_background=LABEL_CODE_BACKGROUND)
        out[f"mAP@{thr}"] = float(np.mean(list(ap.values())))
        out[f"ap@{thr}"] = {int(k): float(v) for k, v in ap.items()}
    iou = evaluators.jaccard_iou_semantic_segmentation(
        masks_pred, gt_masks, labels_codes=LABELS_CODES,
        label_code_background=LABEL_CODE_BACKGROUND)
    out["mIoU"] = float(np.mean(list(iou.values())))
    return out


def _split(detections: np.ndarray):
    """(labels, confidences, corners) of NMS rows [label, p, x0, y0, x1, y1]."""
    return detections[:, :, 0].astype(np.int32), detections[:, :, 1], detections[:, :, 2:]


def nms_grid_search(boxes: torch.Tensor, scores: torch.Tensor, gt: Sequence,
                    max_per_class: int, max_total: int,
                    iou_grid: Sequence[float] = IOU_GRID,
                    prob_grid: Sequence[float] = PROB_GRID) -> dict:
    """The NMS operating point search of reference notebook 03 cells 21-23:
    at every (IoU threshold, probability threshold) of the grid, the port's
    `NonMaximumSuppression` (background rows kept, as the reference runs NMS
    over class 0 too) on the raw outputs ``boxes`` (S, N, 4) yx corners and
    ``scores`` (S, N, C) gated probabilities, on their device, and the
    mAP@0.5 of its detections against ``gt`` ((labels, boxes) a sample).

    Returns {"points": [{"iou", "prob", "mAP@0.5"}] in grid order, "best":
    the first point of the highest mAP@0.5, "detections": its (S, K, 6)
    NumPy rows}."""
    from ssdseglib_torch import evaluators
    from ssdseglib_torch.layers import NonMaximumSuppression

    points, best, best_det = [], None, None
    for iou_thr in iou_grid:
        for prob_thr in prob_grid:
            nms = NonMaximumSuppression(
                max_number_of_boxes_per_class=max_per_class,
                max_number_of_boxes_per_sample=max_total,
                boxes_iou_threshold=iou_thr, labels_probability_threshold=prob_thr,
                suppress_background_boxes=False)
            det = nms(boxes, scores).cpu().numpy()
            ap = evaluators.average_precision_object_detection(
                *_split(det), 0.5, gt, labels_codes=LABELS_CODES,
                label_code_background=LABEL_CODE_BACKGROUND)
            point = {"iou": iou_thr, "prob": prob_thr,
                     "mAP@0.5": float(np.mean(list(ap.values())))}
            points.append(point)
            if best is None or point["mAP@0.5"] > best["mAP@0.5"]:
                best, best_det = point, det
    return {"points": points, "best": best, "detections": best_det}


def _scaled_configs(image_shape: Tuple[int, int]):
    """(anchors config, encoding config, model config) of the warehouse
    configuration at ``image_shape`` (at 480x640 exactly
    `reference_warehouse_config()`'s)."""
    from ssdseglib_torch.config import reference_warehouse_config
    from ssdseglib_torch.examples.train_multitask import anchors_config

    _, enc_cfg, model_cfg, _, _ = reference_warehouse_config()
    enc_cfg = dataclasses.replace(enc_cfg, image_shape=tuple(image_shape))
    model_cfg = dataclasses.replace(model_cfg, input_image_shape=tuple(image_shape) + (3,))
    return anchors_config(image_shape), enc_cfg, model_cfg


def _builder(backbone: str, model_cfg, anchors, enc_cfg, uncapped_head_logits: bool):
    from ssdseglib_torch.models import MobileNetV2SsdSegBuilder, ShuffleNetV2SsdSegBuilder

    kwargs = dict(
        input_image_shape=model_cfg.input_image_shape,
        number_of_boxes_per_point=list(model_cfg.boxes_per_point),
        number_of_classes=model_cfg.number_of_classes,
        center_x_boxes_default=anchors.center_x, center_y_boxes_default=anchors.center_y,
        width_boxes_default=anchors.width, height_boxes_default=anchors.height,
        standard_deviations_centroids_offsets=enc_cfg.standard_deviations,
        detection_head_relu_max=0.0 if uncapped_head_logits else None)
    if backbone == "shufflenetv2":
        # the published 1.5x configuration, the variant the reference ships
        return ShuffleNetV2SsdSegBuilder(model_size="1.5x",
                                         use_additional_depthwise_convolution=True,
                                         use_residual_connections=True, **kwargs)
    return MobileNetV2SsdSegBuilder(**kwargs)


def run(steps: int = 12000, batch_size: int = 16, train_scenes: int = 256,
        eval_scenes: int = 32, peak_lr: float = 2.5e-4, warmup_steps: int = 500,
        eval_every: int = 2000, log_every: int = 200, checkpoint_dir: Optional[str] = None,
        log_file: Optional[str] = None, resume: bool = False, f32: bool = False,
        hnm_ratio: float = 3.0, nms_max_per_class: int = 4, nms_max_total: int = 10,
        precise_bn: int = 0, uncapped_head_logits: bool = False,
        backbone: str = "mobilenetv2", occluded_scenes: bool = False,
        image_shape: Tuple[int, int] = (480, 640), device="cuda", log_fn=print) -> dict:
    """The driver (the module docstring) with the JAX driver's flags as
    arguments, on ``device``, the card unless the caller asks for the CPU;
    returns the result that `main` prints."""
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.checkpoint import Checkpointer
    from ssdseglib_torch.config import NmsConfig, TrainConfig
    from ssdseglib_torch.data.pipeline import TrainDataLoader, upload_batch
    from ssdseglib_torch.data.synthetic import generate_dataset
    from ssdseglib_torch.train import Trainer
    from ssdseglib_torch.utils.logging import MetricsLogger

    t_start = time.perf_counter()
    device = torch.device(device)
    anchors_cfg, enc_cfg, model_cfg = _scaled_configs(image_shape)
    anchors = Anchors.from_config(anchors_cfg, tuple(image_shape))
    train_cfg = TrainConfig(
        batch_size=batch_size, learning_rate=peak_lr, lr_schedule="warmup_cosine",
        lr_warmup_steps=warmup_steps, lr_total_steps=steps, lr_final=peak_lr / 20,
        seed=1993, compute_dtype="float32" if f32 else "bfloat16",
        hnm_negatives_ratio=hnm_ratio if hnm_ratio > 0 else None)

    clean = not occluded_scenes
    train_set = generate_dataset(train_scenes, image_shape=tuple(image_shape),
                                 seed=TRAIN_SCENES_SEED, non_overlapping=clean)
    eval_set = generate_dataset(eval_scenes, image_shape=tuple(image_shape),
                                seed=EVAL_SCENES_SEED, non_overlapping=clean)
    loader = TrainDataLoader(train_set, anchors, enc_cfg, batch_size=batch_size,
                             augmentation_horizontal_flip=True, augmentation_rgb=True,
                             shuffle=False, seed=train_cfg.seed, device=device)
    # every raw batch on the card once: a step reads nothing from the host
    raw_batches = [upload_batch(batch, device) for batch in loader.batcher]
    n_batches = len(raw_batches)
    log_fn(f"{n_batches} train batches resident on {device}")

    builder = _builder(backbone, model_cfg, anchors, enc_cfg, uncapped_head_logits)
    model = builder.get_model_for_training(
        segmentation_dilation_rates=model_cfg.segmentation_dilation_rates,
        generator=torch.Generator().manual_seed(train_cfg.seed), device=device)
    trainer = Trainer(model=model, anchors=anchors, config=train_cfg,
                      standard_deviations=enc_cfg.standard_deviations, device=device)
    state = trainer.init_state(variables=model.state_dict())
    start_step = 0
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state.step)
        log_fn(f"resumed from step {start_step}")

    fused = trainer.fused_train_step_fn(loader.transform)
    generator = torch.Generator(device=device)

    # one serving model for the periodic evaluations, its weights swapped in
    # place; the monitoring NMS point is mid-grid, the final one comes from
    # the grid search
    monitor = NmsConfig(max_boxes_per_class=nms_max_per_class,
                        max_boxes_per_sample=nms_max_total, iou_threshold=0.2,
                        score_threshold=0.5)
    inference = builder.get_model_for_inference(
        model_trained=state.variables(),
        max_number_of_boxes_per_class=monitor.max_boxes_per_class,
        max_number_of_boxes_per_sample=monitor.max_boxes_per_sample,
        boxes_iou_threshold=monitor.iou_threshold,
        labels_probability_threshold=monitor.score_threshold,
        suppress_background_boxes=False, use_segmentation_suppression=True,
        compute_dtype=train_cfg.compute_dtype, fused_backbone=False, device=device)

    eval_loader = TrainDataLoader(eval_set, anchors, enc_cfg, batch_size=batch_size,
                                  shuffle=False, device=device)
    eval_raw = list(eval_loader.batcher)
    gt, gt_masks = [], []
    for images, masks, labels, boxes, valid in eval_raw:
        for i in range(len(images)):
            n = int(valid[i].sum())
            gt.append((labels[i][:n], boxes[i][:n]))
            gt_masks.append(masks[i])

    def recalibrated(state):
        """PreciseBN over the resident training batches (the transform makes
        the images), on a copy of the statistics: training goes on from the
        EMA ones, as in the JAX driver."""
        if not precise_bn:
            return state
        state = dataclasses.replace(
            state, batch_stats={k: v.clone() for k, v in state.batch_stats.items()})
        bn_generator = torch.Generator(device=device)

        def batches():
            for i in range(precise_bn):
                bn_generator.manual_seed(PRECISE_BN_SEED * 1_000_003 + i)
                yield loader.transform(bn_generator, *raw_batches[i % n_batches])

        return trainer.recalibrate_batch_stats(state, batches(), max_batches=precise_bn)

    def serve(state):
        inference.update_variables(recalibrated(state).variables())

    def run_eval(state) -> dict:
        serve(state)
        masks_pred, dets = [], []
        for images, *_ in eval_raw:
            mask, det = inference.predict(images)
            masks_pred.append(mask)
            dets.append(det)
        return evaluate(*_split(np.concatenate(dets)), np.concatenate(masks_pred), gt,
                        gt_masks)

    logger = MetricsLogger(log_file) if log_file else None
    agg, n_agg, evals, logged = {}, 0, [], []
    # the rate window counts the steps timed since its last reset, so windows
    # after a resume, an evaluation or a checkpoint time training alone
    t0, n_rate, train_seconds = time.perf_counter(), 0, 0.0
    stopped = False
    for step in range(start_step, steps):
        generator.manual_seed(STEP_SEED * 1_000_003 + step)
        state, metrics = fused(state, generator, *raw_batches[step % n_batches])
        for k, v in metrics.items():
            agg[k] = v if k not in agg else agg[k] + v
        n_agg += 1
        n_rate += 1
        if (step + 1) % log_every == 0:
            values = {k: float(v) / n_agg for k, v in agg.items()}
            agg, n_agg = {}, 0
            elapsed = time.perf_counter() - t0
            train_seconds += elapsed
            rate = n_rate * batch_size / elapsed
            t0, n_rate = time.perf_counter(), 0
            logged.append({"step": step + 1, **values, "images_per_s": rate})
            log_fn(f"step {step + 1}: loss {values['loss']:.4f} "
                   f"iou/mask {values['iou/mask']:.3f} iou/boxes {values['iou/boxes']:.3f} "
                   f"acc {values['accuracy/labels']:.4f} ({rate:.0f} img/s)")
            if not np.isfinite(values["loss"]):
                log_fn("non-finite loss; stopping")
                stopped = True
                break
            if logger is not None:
                logger.log(values, step=step + 1)
        if (step + 1) % eval_every == 0 or step + 1 == steps:
            train_seconds += time.perf_counter() - t0
            ev = run_eval(state)
            evals.append({"step": step + 1, **ev})
            log_fn(f"  eval @ step {step + 1}: mAP@0.5 {ev['mAP@0.5']:.4f} "
                   f"per-class {ev['ap@0.5']} mIoU {ev['mIoU']:.4f}")
            if logger is not None:
                record = {k: v for k, v in ev.items() if not k.startswith("ap@")}
                # checkpoints hold the EMA statistics; these metrics were taken
                # on the PreciseBN ones when precise_bn > 0
                record["precise_bn"] = precise_bn
                logger.log(record, step=step + 1)
            if ckpt is not None:
                ckpt.save(step + 1, state)
            t0, n_rate = time.perf_counter(), 0
    if ckpt is not None:
        ckpt.wait_until_finished()

    # the NMS operating-point grid search: raw outputs once, then NMS on the
    # card at every point
    log_fn("\nNMS grid search:")
    serve(state)
    raw = [inference.raw_outputs(images) for images, *_ in eval_raw]
    masks_pred = torch.cat([r[0] for r in raw]).cpu().numpy()
    scores = torch.cat([r[1] for r in raw])
    boxes = torch.cat([r[2] for r in raw])
    grid = nms_grid_search(boxes, scores, gt, nms_max_per_class, nms_max_total)
    for point in grid["points"]:
        log_fn(f"  iou {point['iou']:.3f} prob {point['prob']:.2f}: "
               f"mAP@0.5 {point['mAP@0.5']:.4f}")
    best = grid["best"]
    log_fn(f"\nbest operating point: iou {best['iou']} prob {best['prob']} "
           f"(mAP@0.5 {best['mAP@0.5']:.4f})")
    final = evaluate(*_split(grid["detections"]), masks_pred, gt, gt_masks)
    if logger is not None:
        logger.log({"final/mAP@0.5": final["mAP@0.5"], "final/mAP@0.6": final["mAP@0.6"],
                    "final/mAP@0.7": final["mAP@0.7"], "final/mIoU": final["mIoU"],
                    "final/nms_iou": best["iou"], "final/nms_prob": best["prob"]},
                   step=steps)
        logger.close()
    steps_run = state.step - start_step
    return {
        "steps": steps, "steps_run": steps_run, "start_step": start_step,
        "stopped_non_finite": stopped, "batch_size": batch_size,
        "train_scenes": train_scenes, "eval_scenes": eval_scenes,
        "image_shape": list(image_shape), "compute_dtype": train_cfg.compute_dtype,
        "precise_bn": precise_bn, "backbone": backbone,
        "logged": logged, "evals": evals,
        "grid": grid["points"], "best": best, "final": final,
        "train_images_per_s": steps_run * batch_size / train_seconds if train_seconds else None,
        "wall_seconds": time.perf_counter() - t_start,
        "device": str(device),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=12000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--train-scenes", type=int, default=256)
    parser.add_argument("--eval-scenes", type=int, default=32)
    parser.add_argument("--peak-lr", type=float, default=2.5e-4)
    parser.add_argument("--warmup-steps", type=int, default=500)
    parser.add_argument("--eval-every", type=int, default=2000)
    parser.add_argument("--log-every", type=int, default=200)
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--log-file", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--f32", action="store_true", help="disable mixed-precision training")
    parser.add_argument("--hnm-ratio", type=float, default=3.0,
                        help="hard-negative budget (x positives); 3.0 = the reference "
                             "loss; <= 0 selects the all-negatives extension")
    parser.add_argument("--nms-max-per-class", type=int, default=4)
    parser.add_argument("--nms-max-total", type=int, default=10,
                        help="NMS output budget; the reference point is 4/10, but "
                             "background-class rows (the reference runs NMS over class 0 "
                             "too) occupy up to max-per-class slots")
    parser.add_argument("--precise-bn", type=int, default=0,
                        help="re-estimate BN statistics over N training batches "
                             "(PreciseBN) before every evaluation; 0 keeps the EMA "
                             "statistics.  Checkpoints store the EMA statistics")
    parser.add_argument("--uncapped-head-logits", action="store_true",
                        help="remove the reference's ReLU6 cap on the classification "
                             "logits (off = the reference head)")
    parser.add_argument("--backbone", default="mobilenetv2",
                        choices=("mobilenetv2", "shufflenetv2"),
                        help="shufflenetv2 is the published 1.5x configuration")
    parser.add_argument("--occluded-scenes", action="store_true",
                        help="allow overlapping objects (occlusion-noisy ground truth)")
    parser.add_argument("--output", help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("detection learning needs a CUDA device; none is available")
    from ssdseglib_torch.examples.train_multitask import card

    options = {k: v for k, v in vars(args).items() if k != "output"}
    result = run(**options)
    result["card"] = card()
    line = json.dumps(result)
    print(line, flush=True)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0 if not result["stopped_non_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
