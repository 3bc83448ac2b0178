"""Self-contained serving bundles through ``torch.export``.

Counterpart of ``ssdseglib_tpu/export.py``.  The reference deploys by
saving a Keras model (``model.save`` / ``load_model``, reference notebook 03
cells 19/25), which ships code: loading needs the whole framework and
rebuilds the graph.  A bundle here ships the serving program itself: each
program is what `InferenceModel.__call__` runs at one batch size (uint8
images in; forward, decode, segmentation suppression and exact NMS; the
IoU and score thresholds as runtime inputs), captured by ``torch.export``
with every weight and the anchors as inputs, so the weights are stored once
for every baked batch size.  A process reloads and serves a bundle with this
module and the kernels' dispatcher ops only (``torch.ops.ssdseglib.*``,
registered when ``ssdseglib_torch.ops`` modules are imported): no
model-building code, no folding, no retracing.

Layout of a bundle directory:

    program.pt2         the serving program (``torch.export.save``) of a
                        single-batch bundle; a multi-batch bundle writes one
                        program_b{N}.pt2 per baked batch size
    operands.pt         the programs' operands, stored once (``torch.save``
                        of {"network": weights, "anchors_centroids": ...},
                        loaded with ``weights_only=True``); each tensor
                        keeps its strides and gets an allocation of its own
                        on the device, so the kernels' 16-byte alignment
                        holds
    metadata.json       format version, image shape and dtype, batches,
                        device type, mask output, whether int8
                        pointwise convs are in, background filter, the
                        default thresholds, the torch version

The thresholds stay inputs of every program, so `set_nms_operating_point`
retunes a reloaded bundle without a re-export, as it retunes the live model.

Deviation from the JAX package: its bundles can carry a
``compiled_auto.pkl`` sidecar, the executable compiled with XLA's automatic
input layout.  The port's ``input_layout="auto"`` serves through the same
program as ``"default"`` (its stem reads the uint8 NHWC input in place), so
that sidecar has no counterpart.  A model built with ``quantize_pointwise``
exports like any other: its int8 tables are operands in ``operands.pt``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

# the dispatcher ops a program may call are registered by these imports
from ssdseglib_torch.ops import depthwise3x3 as _depthwise3x3  # noqa: F401
from ssdseglib_torch.ops import fused_mbconv as _fused_mbconv  # noqa: F401
from ssdseglib_torch.ops import int8_pointwise as _int8_pointwise  # noqa: F401
from ssdseglib_torch.ops import nms_scan as _nms_scan  # noqa: F401
from ssdseglib_torch.ops import s2d_stem as _s2d_stem  # noqa: F401
from ssdseglib_torch.utils.serving import (
    format_outputs,
    predict_batched_chunks_multi,
    stage_input,
)

FORMAT_VERSION = 1
_PROGRAM_FILE = "program.pt2"
_OPERANDS_FILE = "operands.pt"
_METADATA_FILE = "metadata.json"


class _Program(torch.nn.Module):
    """The module ``torch.export`` captures: `InferenceModel.serving_program`
    with the operands, images and thresholds as its inputs."""

    def __init__(self, infer) -> None:
        super().__init__()
        self._serving_program = infer.serving_program

    def forward(self, operands, images, iou_threshold, score_threshold):
        return self._serving_program(operands, images, iou_threshold, score_threshold)


def save_serving_bundle(infer, path: str, *, batch) -> None:
    """Export ``infer``'s serving program(s) into the directory ``path``.

    infer: an `InferenceModel` (models/builder.py), fused or not.
    batch: the batch size(s) to bake: an int, or a sequence such as
        ``(1, 16)`` for one program per size sharing the one stored operand
        set; `ServingBundle.predict_batched` routes each request to the
        largest program that fits, so a b1 + b16 bundle serves one image at
        b1.
    A model built with ``mesh=`` is refused: a bundle is one device's program.
    """
    if getattr(infer, "mesh", None) is not None:
        raise ValueError(
            "save_serving_bundle exports a single-device program; "
            "build the InferenceModel without mesh="
        )
    batches = [batch] if isinstance(batch, (int, np.integer)) else list(batch)
    if not batches or any(isinstance(b, bool) or int(b) < 1 for b in batches):
        raise ValueError(f"batch sizes must be positive ints, got {batch!r}")
    batches = sorted(set(int(b) for b in batches))
    h, w, c = infer.cfg.input_image_shape
    operands = infer.bundle_operands()
    program = _Program(infer)
    thresholds = (infer._iou_threshold.clone(), infer._score_threshold.clone())
    os.makedirs(path, exist_ok=True)
    programs = {}
    with torch.no_grad():
        for b in batches:
            images = torch.zeros((b, h, w, c), dtype=torch.uint8, device=infer.device)
            exported = torch.export.export(program, (operands, images, *thresholds))
            # the example inputs hold every operand: dropped, so that the
            # operands are stored once, in operands.pt
            exported.example_inputs = None
            filename = _PROGRAM_FILE if len(batches) == 1 else f"program_b{b}.pt2"
            torch.export.save(exported, os.path.join(path, filename))
            programs[str(b)] = filename
    torch.save(operands, os.path.join(path, _OPERANDS_FILE))
    primary = batches[-1]
    meta = {
        "format_version": FORMAT_VERSION,
        "batch": primary,
        "batches": batches,
        "image_shape": [primary, h, w, c],
        "image_dtype": "uint8",
        "programs": programs,
        "device_type": infer.device.type,
        "compute_dtype": infer.compute_dtype,
        "fused_backbone": infer._fused,
        "quantize_pointwise": infer._quantized,
        "mask_output": infer._mask_output,
        "suppress_background_boxes": bool(infer._suppress_background),
        "default_iou_threshold": float(infer._iou_threshold),
        "default_score_threshold": float(infer._score_threshold),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(path, _METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=1)


class ServingBundle:
    """A reloaded bundle: ``bundle(images) -> (mask, detections)`` as device
    tensors, like `InferenceModel.__call__`.  Needs this module and the
    bundle directory only.  The thresholds are retunable with
    `set_nms_operating_point`, as on the live model."""

    def __init__(self, path: str, device=None) -> None:
        """device: where to serve; by default the recorded device type (the
        current card for a "cuda" bundle).  Another device type raises: the
        programs were captured for the recorded one."""
        with open(os.path.join(path, _METADATA_FILE)) as f:
            self.metadata = json.load(f)
        meta = self.metadata
        recorded = meta["device_type"]
        self.device = torch.device(device if device is not None else recorded)
        if self.device.type != recorded:
            raise ValueError(
                f"bundle was exported for {recorded!r}; it cannot serve on "
                f"{self.device.type!r}"
            )
        if recorded == "cuda" and not torch.cuda.is_available():
            raise ValueError("bundle was exported for 'cuda'; no CUDA device is available")
        self._operands = torch.load(os.path.join(path, _OPERANDS_FILE),
                                    map_location=self.device, weights_only=True)
        self._iou = torch.tensor(meta["default_iou_threshold"], dtype=torch.float32,
                                 device=self.device)
        self._score = torch.tensor(meta["default_score_threshold"], dtype=torch.float32,
                                   device=self.device)
        # Each program is called as its graph on the flat inputs: the
        # programs hold no state, so the graph's inputs are the flattened
        # (operands, images, thresholds), and the per-call flattening and
        # input checks of ``ExportedProgram.module()`` (hundreds of operands)
        # are done here once; `__call__` checks the images.
        self._flat_operands = pytree.tree_leaves(self._operands)
        inputs = pytree.tree_structure(
            ((self._operands, self._iou, self._iou, self._score), {}))
        self._programs: Dict[int, Tuple[torch.fx.GraphModule, pytree.TreeSpec]] = {}
        for b, filename in meta["programs"].items():
            exported = torch.export.load(os.path.join(path, filename))
            if exported.call_spec.in_spec != inputs or exported.state_dict or (
                    exported.constants):
                raise ValueError(f"{filename} does not take the operands of {_OPERANDS_FILE}")
            self._programs[int(b)] = (exported.graph_module, exported.call_spec.out_spec)
        self.batches = sorted(self._programs)

    def set_nms_operating_point(
        self,
        boxes_iou_threshold: Optional[float] = None,
        labels_probability_threshold: Optional[float] = None,
    ) -> None:
        """Change the NMS thresholds in place on the device, as
        `InferenceModel.set_nms_operating_point` does."""
        if boxes_iou_threshold is not None:
            self._iou.fill_(float(boxes_iou_threshold))
        if labels_probability_threshold is not None:
            self._score.fill_(float(labels_probability_threshold))

    def prepare_input(self, images) -> torch.Tensor:
        """Stage a host batch on the device (`InferenceModel.prepare_input`)."""
        return stage_input(images, self.device)

    def __call__(self, images):
        """(formatted mask, detections) as device tensors, not waited for;
        ``images`` of a baked batch size and the exported image shape."""
        shape = tuple(images.shape)
        hwc = tuple(self.metadata["image_shape"][1:])
        b = shape[0] if len(shape) == 4 else None
        if len(shape) != 4 or shape[1:] != hwc or b not in self._programs:
            raise ValueError(
                f"bundle was exported for images of shape "
                f"({'|'.join(map(str, self.batches))}, "
                f"{', '.join(map(str, hwc))}), got {shape} — use "
                "predict_batched for arbitrary N, or re-export with this "
                "batch size included"
            )
        graph, outputs = self._programs[b]
        with torch.inference_mode():
            flat = graph(*self._flat_operands, self.prepare_input(images), self._iou,
                         self._score)
        return pytree.tree_unflatten(flat, outputs)

    def predict(self, images):
        """NumPy-in/NumPy-out, with `InferenceModel.predict`'s conventions,
        including the host-side background-box filter (reference
        layers.py:165-166) when the exported model had it."""
        mask, det = self(images)
        return format_outputs(mask, det, self.metadata["suppress_background_boxes"])

    def predict_batched(self, images):
        """Serve any number of images through the baked batch sizes with
        `predict`'s conventions: each chunk goes to the largest program that
        fits (`utils.serving.plan_batched_chunks`), a ragged tail below the
        smallest one is repeat-padded."""
        mask, det = predict_batched_chunks_multi(images, self.batches, self)
        return format_outputs(mask, det, self.metadata["suppress_background_boxes"])


def load_serving_bundle(path: str, device=None) -> ServingBundle:
    """Load a bundle written by `save_serving_bundle` (see `ServingBundle`)."""
    return ServingBundle(path, device)
