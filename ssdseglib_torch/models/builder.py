"""Model assembly and serving (PyTorch), counterpart of
ssdseglib_tpu/models/builder.py.

`SsdSegModel` is the joint SSDLite + DeepLabV3+ network on MobileNetV2,
ShuffleNetV2 or MobileNetV3-Large (built in eval mode; ``.train()`` reaches
every BatchNorm for the trainer); `InferenceModel` is the serving path:
forward -> decode -> segmentation gating -> exact NMS, on one device,
data-parallel over a mesh
(`parallel.make_mesh`) or over a ``("data", "spatial")`` mesh that splits the
rows too (`parallel.make_hybrid_mesh`), with the NMS thresholds held as 0-d
device tensors so
an operating point changes without any host synchronisation.
`MobileNetV2SsdSegBuilder` and `ShuffleNetV2SsdSegBuilder` mirror the
reference builder surface; `MobileNetV3LargeSsdSegBuilder`, the port's own,
takes `MobileNetV2SsdSegBuilder`'s.

`TrainableModel` is `SsdSegModel` under the reference's name: the
``nn.Module`` is the trainable model (it has `parameter_counts`), and Flax's
init / apply pair has no counterpart to wrap.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.layers import (
    DecodeBoxesCentroidsOffsets,
    NonMaximumSuppression,
    SegmentationSuppression,
)
from ssdseglib_torch.models.blocks import SepConvBN, init_weights
from ssdseglib_torch.models.heads import (
    DeepLabV3PlusDecoder,
    DeepLabV3PlusEncoder,
    SsdLiteHeads,
)
from ssdseglib_torch.models.mobilenetv2 import MobileNetV2Backbone
from ssdseglib_torch.models.mobilenetv3 import (
    LAST_BLOCK,
    LAST_CHANNELS,
    MobileNetV3LargeBackbone,
)
from ssdseglib_torch.models.shufflenetv2 import STAGE_CHANNELS, ShuffleNetV2Backbone
from ssdseglib_torch.ops.encoding import decode_predictions_to_corners_yx
from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.parallel import spatial
from ssdseglib_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _backbone_head_config(cfg: ModelConfig):
    """Per-backbone head wiring: relu cap + extra pyramid block specs."""
    if cfg.backbone == "mobilenetv2":
        return 6.0, ((320, "backbone-block17"), (360, "backbone-block18"))
    if cfg.backbone == "shufflenetv2":
        c4 = STAGE_CHANNELS[cfg.shufflenet_size][4]
        return 0.0, ((c4, "backbone-stage5-block1"), (c4, "backbone-stage5-block2"))
    if cfg.backbone == "mobilenetv3_large":
        # the first two depths of SSDLite's extra layers (Howard et al., 2019,
        # section 6.2), under MobileNetV2's names
        return 6.0, ((512, "backbone-block17"), (256, "backbone-block18"))
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


def _backbone(cfg: ModelConfig):
    """(backbone module, its three taps (fm1 os16, fm2 os32, decoder skip),
    their channels)."""
    if cfg.backbone == "mobilenetv2":
        taps = ("backbone-block13-expand-relu6",  # os16
                "backbone-block16-project-batchnorm",  # os32
                "backbone-block3-expand-relu6")  # os4
        return MobileNetV2Backbone(), taps, (96 * 6, 320, 24 * 6)
    if cfg.backbone == "shufflenetv2":
        channels = STAGE_CHANNELS[cfg.shufflenet_size]
        taps = ("backbone-stage3-block7",  # os16
                "backbone-stage4-block3",  # os32
                "backbone-stage2-block3")  # os8
        backbone = ShuffleNetV2Backbone(
            cfg.shufflenet_size,
            use_additional_depthwise_convolution=cfg.shufflenet_extra_depthwise,
            use_residual_connections=cfg.shufflenet_residuals,
        )
        return backbone, taps, (channels[3], channels[4], channels[2])
    if cfg.backbone == "mobilenetv3_large":
        # section 6.2's C4, the expansion of block 13 (672, os16), and C5, the
        # 1x1 conv of 960 (os32); the decoder's skip is block 4's expansion
        # (72, os4), as MobileNetV2's is block 3's
        taps = ("backbone-block13-expand", f"backbone-block{LAST_BLOCK}-expand",
                "backbone-block4-expand")
        return MobileNetV3LargeBackbone(), taps, (672, LAST_CHANNELS, 72)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


class SsdSegModel(nn.ModuleDict):
    """Backbone + DeepLabV3+ mask head + SSDLite detection heads.

    ``forward(images)`` takes NHWC images in [0, 255] and returns a dict
    keyed like the reference model's named outputs: 'output-mask'
    (B, H, W, C) softmax, 'output-labels' (B, N, 4) softmax, 'output-boxes'
    (B, N, num_classes) raw offsets.  Init is Flax's (lecun-normal convs,
    identity BatchNorm), drawn from ``generator``.
    """

    def __init__(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        super().__init__()
        relu_max, extra = _backbone_head_config(cfg)
        self.cfg = cfg
        self["backbone"], self.taps, (fm1_c, fm2_c, skip_c) = _backbone(cfg)
        self[extra[0][1]] = SepConvBN(fm2_c, extra[0][0], 3, strides=2,
                                      relu_max=relu_max)
        self[extra[1][1]] = SepConvBN(extra[0][0], extra[1][0], 3, strides=2,
                                      relu_max=relu_max)
        self["mask-encoder"] = DeepLabV3PlusEncoder(
            fm1_c, 256, cfg.segmentation_dilation_rates, relu_max
        )
        self["mask-decoder"] = DeepLabV3PlusDecoder(
            256, skip_c, 48, 256, cfg.input_image_shape[:2],
            cfg.number_of_classes, relu_max,
        )
        head_relu_max = (
            cfg.detection_head_relu_max
            if cfg.detection_head_relu_max is not None
            else relu_max
        )
        self["heads"] = SsdLiteHeads(
            (fm1_c, fm2_c, extra[0][0], extra[1][0]), cfg.boxes_per_point,
            cfg.number_of_classes, head_relu_max,
        )
        self.extra = tuple(name for _, name in extra)
        init_weights(self, generator)
        self.eval()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # on a mesh that splits the rows, images are this rank's rows; the
        # ASPP's dilated convs read up to the largest rate across a shard's
        # edge of the os16 map (fm1), every other window one row
        halos = {16: max(self.cfg.segmentation_dilation_rates)}
        with spatial.row_partition(images, halos):
            # NHWC -> channels-last NCHW view; rescale [0, 255] -> [-1, 1]
            x = images.permute(0, 3, 1, 2) / 127.5 - 1.0
            _, taps = self["backbone"](x)
            return self.apply_heads(*(taps[name] for name in self.taps))

    def apply_heads(self, fm1: torch.Tensor, fm2: torch.Tensor,
                    skip: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Everything after the backbone, on its three NCHW taps."""
        fm3 = self[self.extra[0]](fm2)
        fm4 = self[self.extra[1]](fm3)
        mask = self["mask-decoder"](self["mask-encoder"](fm1), skip)
        labels, boxes = self["heads"]([fm1, fm2, fm3, fm4])
        return {
            "output-mask": mask.permute(0, 2, 3, 1),
            "output-labels": labels,
            "output-boxes": boxes,
        }

    def parameter_counts(self) -> Tuple[int, int]:
        """(trainable, non-trainable) parameter counts, as `count_parameters`
        gives them."""
        return count_parameters(self)


# the reference's name for the model a builder hands out for training
TrainableModel = SsdSegModel


def count_parameters(model: nn.Module) -> Tuple[int, int]:
    """(trainable, non-trainable) parameter counts, Keras-summary style:
    the BatchNorm running statistics are the non-trainable ones."""
    trainable = sum(p.numel() for p in model.parameters())
    stats = sum(
        b.numel() for name, b in model.named_buffers()
        if name.endswith(("running_mean", "running_var"))
    )
    return int(trainable), int(stats)


def _format_mask(mask: torch.Tensor, mask_output: str) -> torch.Tensor:
    """Serving mask output format: 'float32' probabilities (reference
    behavior), 'bfloat16' probabilities (half the bytes), or 'class_map'
    (uint8 argmax, first index on ties)."""
    if mask_output == "float32":
        return mask.float()
    if mask_output == "bfloat16":
        return mask.to(torch.bfloat16)
    if mask_output == "class_map":
        return mask.argmax(dim=-1).to(torch.uint8)
    raise ValueError(
        f"mask_output must be 'float32', 'bfloat16' or 'class_map'; "
        f"got {mask_output!r}"
    )


class InferenceModel:
    """End-to-end serving on one device: forward -> decode -> gate -> NMS.

    `predict` returns (mask (B, H, W, C), detections (B, T, 6)) with
    detection rows [label, probability, xmin, ymin, xmax, ymax]; `__call__`
    returns the same as device tensors without waiting for them.

    With a ``mesh`` every rank is given the same global batch, serves its
    slice through the same program (the segmentation suppression reduces
    class presence over the global batch), and `__call__` returns this
    rank's slice -- on a mesh that splits the rows, its rows of the mask and
    the detections of its batch slice; `predict` and `predict_batched`
    return the whole batch on every rank, as the JAX package's host arrays
    are.  The weights are the mesh's first rank's, on every rank.

    What a call runs is `serving_program(operands, images, iou_threshold,
    score_threshold)`: a function of its arguments only, so
    `export_serving_bundle` captures it with ``torch.export`` and the
    weights, anchors and thresholds as inputs.
    """

    def __init__(
        self,
        module: SsdSegModel,
        decode: DecodeBoxesCentroidsOffsets,
        nms: NonMaximumSuppression,
        use_segmentation_suppression: bool,
        suppress_background_boxes: bool,
        compute_dtype: str = "float32",
        fused_backbone: bool = False,
        mask_output: str = "float32",
        device="cuda",
        mesh=None,
        input_layout: str = "default",
        input_layout_batch: int = 16,
        quantize_pointwise: bool = False,
        calibration_images=None,
        s2d_stem=False,
    ) -> None:
        """compute_dtype: 'bfloat16' is the serving fast path (weights and
        convs in bf16); decode, gating and NMS always run in f32.

        fused_backbone: the BN-folded forward (models/fused_inference.py):
        on MobileNetV2 with the fused MBConv kernel, on MobileNetV3-Large
        with its squeeze-and-excitation and hard activations; in bfloat16
        every depthwise 3x3 conv runs the depthwise kernel.  ShuffleNetV2
        raises.  Otherwise the eval-mode module runs as it is, in
        compute_dtype.

        mask_output: 'float32' | 'bfloat16' | 'class_map' (`_format_mask`).

        mesh: a 1-D data mesh (`parallel.make_mesh`) for batch-parallel
        serving, a ``("data", "spatial")`` one (`parallel.make_hybrid_mesh`)
        for batch- and row-parallel serving, or None.  On a mesh that splits
        the rows the fused forward runs under the model's row partition
        (`fused_inference.fused_forward`): its kernels on this rank's windows
        of rows, the int8 1x1s on its rows as they are.  The folded
        MobileNetV3-Large takes no spatial mesh.

        quantize_pointwise / calibration_images: int8 post-training
        quantization of the two pointwise convs of
        `fused_inference.QUANT_TARGETS`, calibrated on a representative
        uint8 batch; requires ``fused_backbone`` on MobileNetV2.  On a mesh (data or
        spatial) every rank calibrates on the whole batch with the replicated
        weights, outside any row partition, so every rank holds one
        process's tables.

        s2d_stem: the stem + block 1 route of the fused forward, False,
        ``"cuda"`` (the fused kernel) or ``"xla"`` (the packed conv
        reformulation) (`fused_inference.make_fused_forward`); requires
        ``fused_backbone`` on MobileNetV2.

        input_layout / input_layout_batch: the JAX package's 'auto' compiles
        a program with XLA-chosen input layouts for one batch size.  The
        port's stem already reads the uint8 NHWC input in place as a
        channels-last view, so 'auto' serves through the same program as
        'default' and ``input_layout_batch`` changes nothing; the values are
        validated as the JAX package validates them.
        """
        if quantize_pointwise and not fused_backbone:
            raise ValueError(
                "quantize_pointwise requires fused_backbone=True (the int8 "
                "pointwise convs live in the folded-heads serving path)"
            )
        if s2d_stem and not fused_backbone:
            raise ValueError("s2d_stem requires fused_backbone=True")
        if (fused_backbone and module.cfg.backbone == "mobilenetv3_large" and mesh is not None
                and spatial.has_spatial_axis(mesh)):
            raise ValueError("fused inference of mobilenetv3_large takes no ('data', 'spatial') "
                             "mesh; a 1-D data mesh serves it")
        if input_layout not in ("default", "auto"):
            raise ValueError(
                f"input_layout must be 'default' or 'auto', got {input_layout!r}"
            )
        if input_layout == "auto" and mesh is not None:
            raise ValueError("input_layout='auto' is single-device only")
        if compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}"
            )
        if mask_output not in ("float32", "bfloat16", "class_map"):
            raise ValueError(
                "mask_output must be 'float32', 'bfloat16' or 'class_map', "
                f"got {mask_output!r}"
            )
        self.device = torch.device(device)
        self.mesh = mesh
        self.cfg = module.cfg
        self.compute_dtype = compute_dtype
        self._dtype = _DTYPES[compute_dtype]
        self._mask_output = mask_output
        self._suppress_background = suppress_background_boxes
        self._fused = fused_backbone
        self._quantized = bool(quantize_pointwise)
        self._standard_deviations = decode.standard_deviations
        self._nms = NonMaximumSuppression(
            nms.config.max_boxes_per_class, nms.config.max_boxes_per_sample,
            nms.config.iou_threshold, nms.config.score_threshold,
        )
        self._seg_suppression = (
            SegmentationSuppression(num_classes=4)  # reference depth=4 (layers.py:204)
            if use_segmentation_suppression else None
        )
        # runtime-tunable NMS operating point (see set_nms_operating_point)
        self._iou_threshold = torch.tensor(
            nms.config.iou_threshold, dtype=torch.float32, device=self.device
        )
        self._score_threshold = torch.tensor(
            nms.config.score_threshold, dtype=torch.float32, device=self.device
        )
        anchors = decode.anchors_centroids.to(self.device)
        state_dict = module.state_dict()
        if mesh is not None:
            state_dict = mesh_lib.replicate(mesh, state_dict)
        if fused_backbone:
            from ssdseglib_torch.models.fused_inference import (
                check_fused_options,
                fused_forward,
                fused_operands,
            )

            cfg = module.cfg
            check_fused_options(cfg, s2d_stem, quantize_pointwise)
            self._net = None
            # fold BN from the f32 weights, then cast to the compute dtype
            weights = fused_operands(cfg, state_dict, self._dtype, self.device,
                                     s2d_stem=s2d_stem,
                                     quantize_pointwise=quantize_pointwise,
                                     calibration_images=calibration_images)

            def network(weights, images):
                return fused_forward(cfg, weights, images, s2d_stem)
        else:
            net = copy.deepcopy(module)
            if mesh is not None:
                net.load_state_dict(state_dict)
            net = net.to(device=self.device, dtype=self._dtype)
            self._net = net.to(memory_format=torch.channels_last).eval()
            weights = None  # the module's own tensors; a bundle passes them

            def network(weights, images):
                x = images.to(self._dtype)
                if weights is None:
                    return self._net(x)
                return torch.func.functional_call(self._net, weights, (x,))
        self._network = network
        self._operands = {"network": weights, "anchors_centroids": anchors}
        self._calls = 0

    def serving_core(self, operands, images: torch.Tensor):
        """Forward + decode + gating: (mask, gated labels, boxes_yx)."""
        out = self._network(operands["network"], images)
        # the fused path keeps the mask in the compute dtype for the gating
        # argmax, as the JAX package does; the plain path gates on f32
        mask = out["output-mask"] if self._fused else out["output-mask"].float()
        labels = out["output-labels"].float()
        if self._seg_suppression is not None:
            labels = self._seg_suppression(mask, labels)
        boxes_yx = decode_predictions_to_corners_yx(
            out["output-boxes"].float(), operands["anchors_centroids"],
            self._standard_deviations,
        )
        return mask, labels, boxes_yx

    def _serving_nms(self, mask, labels, boxes_yx, iou_threshold: torch.Tensor,
                     score_threshold: torch.Tensor):
        """NMS and the mask's output format: (formatted mask, detections)
        from `serving_core`'s outputs."""
        detections = self._nms(
            boxes_yx, labels, iou_threshold=iou_threshold,
            score_threshold=score_threshold,
        )
        return _format_mask(mask, self._mask_output), detections

    def serving_program(self, operands, images: torch.Tensor,
                        iou_threshold: torch.Tensor, score_threshold: torch.Tensor):
        """(formatted mask, detections) of one batch: what `__call__` runs,
        as a function of its arguments (the tensors of `bundle_operands` or
        this model's own, uint8 NHWC images, 0-d f32 thresholds)."""
        return self._serving_nms(*self.serving_core(operands, images), iou_threshold,
                                 score_threshold)

    def bundle_operands(self):
        """Every tensor `serving_program` reads besides the images and
        thresholds, on this model's device: what a serving bundle stores
        once."""
        weights = self._operands["network"]
        if weights is None:
            weights = dict(self._net.state_dict())
        return {"network": weights, "anchors_centroids": self._operands["anchors_centroids"]}

    @torch.inference_mode()
    def _core(self, images: torch.Tensor):
        with mesh_lib.data_parallel(self.mesh):
            return self.serving_core(self._operands, images)

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, call: int):
        """`serving_program` on this model's operands, its two steps in the
        spans ``serve.core`` and ``serve.nms`` of call number ``call``."""
        with mesh_lib.data_parallel(self.mesh):
            with span("serve.core", call):
                core = self.serving_core(self._operands, images)
            with span("serve.nms", call):
                return self._serving_nms(*core, self._iou_threshold, self._score_threshold)

    def update_variables(self, state_dict) -> None:
        """Swap in new weights (a `SsdSegModel` state_dict, any float dtype)
        without rebuilding: they are cast into this model's tensors in
        place.  Used for periodic in-training evaluation; not available with
        ``fused_backbone=True`` (the folded weights are derived, as in the
        JAX package, where they are baked into the jit).  On a mesh, rank
        0's weights are loaded on every rank."""
        if self._fused:
            raise ValueError(
                "update_variables is not supported with fused_backbone=True"
            )
        if self.mesh is not None:
            state_dict = mesh_lib.replicate(self.mesh, dict(state_dict))
        self._net.load_state_dict(state_dict)

    def prepare_input(self, images) -> torch.Tensor:
        """Stage a host batch on the device: NumPy goes through pinned host
        memory with a non-blocking upload; a tensor is moved as it is.  On a
        mesh, this rank's slice of the global batch (`parallel.shard_images`)."""
        from ssdseglib_torch.utils.serving import stage_input

        if self.mesh is not None:
            images = mesh_lib.shard_images(self.mesh, images)
        return stage_input(images, self.device)

    def set_nms_operating_point(
        self,
        boxes_iou_threshold: Optional[float] = None,
        labels_probability_threshold: Optional[float] = None,
    ) -> None:
        """Change the NMS thresholds in place on the device: no rebuild, and
        the update is ordered after every call already queued."""
        if boxes_iou_threshold is not None:
            self._iou_threshold.fill_(float(boxes_iou_threshold))
        if labels_probability_threshold is not None:
            self._score_threshold.fill_(float(labels_probability_threshold))

    def raw_outputs(self, images):
        """Forward + decode + gating WITHOUT the NMS step: (mask (B,H,W,C),
        gated labels (B,N,C), decoded boxes_yx (B,N,4)), all f32 device
        tensors.  Feeds NMS operating-point grid searches."""
        mask, labels, boxes_yx = self._core(self.prepare_input(images))
        return mask.float(), labels, boxes_yx

    def __call__(self, images):
        """(formatted mask, detections) as device tensors, not waited for.
        While a profiler records, the call is the span ``serve.request``,
        indexed by the model's call number, over ``serve.stage`` (the
        upload), ``serve.core`` and ``serve.nms`` (`utils.profiling.span`)."""
        call = self._calls
        self._calls += 1
        with span("serve.request", call):
            with span("serve.stage", call):
                staged = self.prepare_input(images)
            return self._forward(staged, call)

    def export_serving_bundle(self, path: str, *, batch) -> None:
        """Write this model's serving program, one per batch size in
        ``batch``, and its operands, stored once, into a self-contained
        bundle directory that `ssdseglib_torch.export.load_serving_bundle`
        reloads and serves without the model-building code.  See
        `ssdseglib_torch.export.save_serving_bundle`."""
        from ssdseglib_torch.export import save_serving_bundle

        save_serving_bundle(self, path, batch=batch)

    def predict(self, images):
        """NumPy-in/NumPy-out, applying the optional host-side
        background-box filter (reference layers.py:165-166).  A bf16 mask
        comes back as float32 NumPy; 'class_map' returns the uint8 map."""
        from ssdseglib_torch.utils.serving import format_outputs

        mask, det = self._whole_batch(images)
        return format_outputs(mask, det, self._suppress_background)

    def _whole_batch(self, images):
        """`__call__`'s (mask, detections) of the whole batch: on a mesh the
        ranks' blocks gathered on every rank (`utils.serving.gather_outputs`)."""
        from ssdseglib_torch.utils.serving import gather_outputs

        mask, det = self(images)
        if self.mesh is None:
            return mask, det
        return gather_outputs(mask, det, self.mesh)

    def predict_batched(self, images, batch: int = 16):
        """Serve any number of images at one batch size, with `predict`'s
        NumPy conventions -- see `utils.serving.predict_batched_chunks` for
        the chunk / repeat-pad / slice protocol and why repeat-padding
        keeps the batch-global segmentation suppression exact."""
        from ssdseglib_torch.utils.serving import (
            format_outputs,
            predict_batched_chunks,
        )

        mask, det = predict_batched_chunks(images, batch, self._whole_batch)
        return format_outputs(mask, det, self._suppress_background)


class _BuilderBase:
    """Shared builder logic mirroring the reference builder ctor surface."""

    def __init__(
        self,
        input_image_shape,
        number_of_boxes_per_point,
        number_of_classes,
        center_x_boxes_default,
        center_y_boxes_default,
        width_boxes_default,
        height_boxes_default,
        standard_deviations_centroids_offsets,
        backbone: str,
        **backbone_kwargs,
    ) -> None:
        if isinstance(number_of_boxes_per_point, int):
            number_of_boxes_per_point = (number_of_boxes_per_point,) * 4
        self.cfg_base = dict(
            input_image_shape=tuple(input_image_shape),
            number_of_classes=number_of_classes,
            boxes_per_point=tuple(number_of_boxes_per_point),
            backbone=backbone,
            **backbone_kwargs,
        )
        self._anchors_centroids = (
            np.asarray(center_x_boxes_default, np.float32),
            np.asarray(center_y_boxes_default, np.float32),
            np.asarray(width_boxes_default, np.float32),
            np.asarray(height_boxes_default, np.float32),
        )
        self._stds = tuple(float(s) for s in standard_deviations_centroids_offsets)
        self._model_cfg: Optional[ModelConfig] = None

    def get_model_for_training(
        self,
        segmentation_architecture: str = "deeplabv3plus",
        object_detection_architecture: str = "ssdlite",
        segmentation_dilation_rates: Tuple[int, int, int] = (6, 12, 18),
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ) -> SsdSegModel:
        """The network with fresh weights drawn from ``generator`` (a
        ``torch.Generator`` seeded 0 when None), on ``device``: the card
        unless the caller asks for the CPU."""
        if segmentation_architecture != "deeplabv3plus":
            raise ValueError("only 'deeplabv3plus' segmentation is available")
        if object_detection_architecture != "ssdlite":
            raise ValueError("only 'ssdlite' object detection is available")
        self._model_cfg = ModelConfig(
            segmentation_dilation_rates=tuple(segmentation_dilation_rates),
            **self.cfg_base,
        )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return SsdSegModel(self._model_cfg, generator).to(device)

    def get_model_for_inference(
        self,
        model_trained,
        max_number_of_boxes_per_class: int,
        max_number_of_boxes_per_sample: int,
        boxes_iou_threshold: float,
        labels_probability_threshold: float,
        suppress_background_boxes: bool,
        use_segmentation_suppression: bool,
        compute_dtype: str = "float32",
        fused_backbone: bool = False,
        mask_output: str = "float32",
        device="cuda",
        mesh=None,
        input_layout: str = "default",
        input_layout_batch: int = 16,
        quantize_pointwise: bool = False,
        calibration_images=None,
        s2d_stem=False,
    ) -> InferenceModel:
        """Args:
            model_trained: the trained `SsdSegModel`, or its state_dict.
            compute_dtype: 'bfloat16' for the serving fast path.
            fused_backbone: the BN-folded forward (MobileNetV2 through the
                fused MBConv kernel, MobileNetV3-Large; ShuffleNetV2 raises
                ValueError).
            mask_output: 'float32' | 'bfloat16' | 'class_map'.
            device: where the model serves; the card unless the caller
                asks for the CPU.
            mesh: a 1-D data mesh (`parallel.make_mesh`) for batch-parallel
                serving over its ranks, or a ``("data", "spatial")`` one
                (`parallel.make_hybrid_mesh`) that splits the rows too
                (`InferenceModel`).
            input_layout / input_layout_batch: 'default' | 'auto'; the same
                program either way on the port (`InferenceModel`).
            quantize_pointwise / calibration_images: opt-in int8 PTQ of the
                two pointwise convs of `fused_inference.QUANT_TARGETS`;
                requires fused_backbone on MobileNetV2 and a representative
                calibration batch in [0, 255].
            s2d_stem: the fused forward's stem + block 1 route, False,
                ``"cuda"`` or ``"xla"``; requires fused_backbone on
                MobileNetV2 (`InferenceModel`).
        """
        if isinstance(model_trained, SsdSegModel):
            module = model_trained
        else:
            if self._model_cfg is None:
                self.get_model_for_training(device="cpu")  # sets the config only
            module = SsdSegModel(self._model_cfg, torch.Generator().manual_seed(0))
            module.load_state_dict(model_trained)

        decode = DecodeBoxesCentroidsOffsets(*self._anchors_centroids, *self._stds)
        nms = NonMaximumSuppression(
            max_number_of_boxes_per_class=max_number_of_boxes_per_class,
            max_number_of_boxes_per_sample=max_number_of_boxes_per_sample,
            boxes_iou_threshold=boxes_iou_threshold,
            labels_probability_threshold=labels_probability_threshold,
        )
        return InferenceModel(
            module=module,
            decode=decode,
            nms=nms,
            use_segmentation_suppression=use_segmentation_suppression,
            suppress_background_boxes=suppress_background_boxes,
            compute_dtype=compute_dtype,
            fused_backbone=fused_backbone,
            mask_output=mask_output,
            device=device,
            mesh=mesh,
            input_layout=input_layout,
            input_layout_batch=input_layout_batch,
            quantize_pointwise=quantize_pointwise,
            calibration_images=calibration_images,
            s2d_stem=s2d_stem,
        )


class MobileNetV2SsdSegBuilder(_BuilderBase):
    """Mirror of reference MobileNetV2SsdSegBuilder (models.py:6-45)."""

    def __init__(
        self,
        input_image_shape,
        number_of_boxes_per_point,
        number_of_classes,
        center_x_boxes_default,
        center_y_boxes_default,
        width_boxes_default,
        height_boxes_default,
        standard_deviations_centroids_offsets,
        **model_kwargs,
    ) -> None:
        """model_kwargs: extra ModelConfig fields beyond the reference ctor
        surface (e.g. detection_head_relu_max=0.0 for uncapped logits)."""
        super().__init__(
            input_image_shape,
            number_of_boxes_per_point,
            number_of_classes,
            center_x_boxes_default,
            center_y_boxes_default,
            width_boxes_default,
            height_boxes_default,
            standard_deviations_centroids_offsets,
            backbone="mobilenetv2",
            **model_kwargs,
        )


class MobileNetV3LargeSsdSegBuilder(_BuilderBase):
    """MobileNetV3-Large (`models/mobilenetv3.py`) on the same heads, with
    `MobileNetV2SsdSegBuilder`'s ctor surface.  The port's own: the
    reference and the JAX package have no such builder."""

    def __init__(
        self,
        input_image_shape,
        number_of_boxes_per_point,
        number_of_classes,
        center_x_boxes_default,
        center_y_boxes_default,
        width_boxes_default,
        height_boxes_default,
        standard_deviations_centroids_offsets,
        **model_kwargs,
    ) -> None:
        """model_kwargs: extra ModelConfig fields, as for
        MobileNetV2SsdSegBuilder."""
        super().__init__(
            input_image_shape,
            number_of_boxes_per_point,
            number_of_classes,
            center_x_boxes_default,
            center_y_boxes_default,
            width_boxes_default,
            height_boxes_default,
            standard_deviations_centroids_offsets,
            backbone="mobilenetv3_large",
            **model_kwargs,
        )


class ShuffleNetV2SsdSegBuilder(_BuilderBase):
    """Mirror of reference ShuffleNetV2SsdSegBuilder (models.py:425-478)."""

    def __init__(
        self,
        input_image_shape,
        model_size,
        use_additional_depthwise_convolution,
        use_residual_connections,
        number_of_boxes_per_point,
        number_of_classes,
        center_x_boxes_default,
        center_y_boxes_default,
        width_boxes_default,
        height_boxes_default,
        standard_deviations_centroids_offsets,
        **model_kwargs,
    ) -> None:
        """model_kwargs: extra ModelConfig fields beyond the reference ctor
        surface, as for MobileNetV2SsdSegBuilder."""
        if model_size not in STAGE_CHANNELS:
            raise ValueError(
                'invalid "model_size" value! available values are '
                '"0.5x", "1x", "1.5x", "2x"'
            )
        super().__init__(
            input_image_shape,
            number_of_boxes_per_point,
            number_of_classes,
            center_x_boxes_default,
            center_y_boxes_default,
            width_boxes_default,
            height_boxes_default,
            standard_deviations_centroids_offsets,
            backbone="shufflenetv2",
            shufflenet_size=model_size,
            shufflenet_extra_depthwise=use_additional_depthwise_convolution,
            shufflenet_residuals=use_residual_connections,
            **model_kwargs,
        )
