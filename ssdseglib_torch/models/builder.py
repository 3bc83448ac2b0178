"""Model assembly and serving (PyTorch), counterpart of
ssdseglib_tpu/models/builder.py.

`SsdSegModel` is the joint SSDLite + DeepLabV3+ network on MobileNetV2 (built
in eval mode; ``.train()`` reaches every BatchNorm for the trainer);
`InferenceModel` is the serving path: forward -> decode ->
segmentation gating -> exact NMS, on one device, with the NMS thresholds
held as 0-d device tensors so an operating point changes without any host
synchronisation.  `MobileNetV2SsdSegBuilder` mirrors the reference builder
surface.
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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _backbone_head_config(cfg: ModelConfig):
    """Per-backbone head wiring: relu cap + extra pyramid block specs."""
    if cfg.backbone == "mobilenetv2":
        return 6.0, ((320, "backbone-block17"), (360, "backbone-block18"))
    raise ValueError(
        f"backbone {cfg.backbone!r} is not ported (mobilenetv2 only)"
    )


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
        self["backbone"] = MobileNetV2Backbone()
        fm1_c, fm2_c, skip_c = 96 * 6, 320, 24 * 6  # block13/3 expand, block16 out
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
        # NHWC -> channels-last NCHW view; rescale [0, 255] -> [-1, 1]
        x = images.permute(0, 3, 1, 2) / 127.5 - 1.0
        _, taps = self["backbone"](x)
        fm1 = taps["backbone-block13-expand-relu6"]  # os16
        fm2 = taps["backbone-block16-project-batchnorm"]  # os32
        skip = taps["backbone-block3-expand-relu6"]  # os4
        fm3 = self[self.extra[0]](fm2)
        fm4 = self[self.extra[1]](fm3)
        mask = self["mask-decoder"](self["mask-encoder"](fm1), skip)
        labels, boxes = self["heads"]([fm1, fm2, fm3, fm4])
        return {
            "output-mask": mask.permute(0, 2, 3, 1),
            "output-labels": labels,
            "output-boxes": boxes,
        }


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
    ) -> None:
        """compute_dtype: 'bfloat16' is the serving fast path (weights and
        convs in bf16); decode, gating and NMS always run in f32.

        fused_backbone: BN-folded forward with the fused MBConv kernel
        (models/fused_inference.py); every batch goes through the kernel.
        Otherwise the eval-mode module runs as it is, in compute_dtype.

        mask_output: 'float32' | 'bfloat16' | 'class_map' (`_format_mask`).
        """
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
        self._dtype = _DTYPES[compute_dtype]
        self._mask_output = mask_output
        self._suppress_background = suppress_background_boxes
        self._fused = fused_backbone
        self._decode = copy.copy(decode).to(self.device)
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
        if fused_backbone:
            from ssdseglib_torch.models.fused_inference import make_fused_forward

            # fold BN from the f32 weights, then cast to the compute dtype
            self._network = make_fused_forward(
                module.cfg, module.state_dict(), self._dtype, self.device
            )
        else:
            net = copy.deepcopy(module).to(device=self.device, dtype=self._dtype)
            net = net.to(memory_format=torch.channels_last).eval()
            self._network = lambda images: net(images.to(self._dtype))

    @torch.inference_mode()
    def _core(self, images: torch.Tensor):
        out = self._network(images)
        # the fused path keeps the mask in the compute dtype for the gating
        # argmax, as the JAX package does; the plain path gates on f32
        mask = out["output-mask"] if self._fused else out["output-mask"].float()
        labels = out["output-labels"].float()
        if self._seg_suppression is not None:
            labels = self._seg_suppression(mask, labels)
        boxes_yx = self._decode(out["output-boxes"].float())
        return mask, labels, boxes_yx

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor):
        mask, labels, boxes_yx = self._core(images)
        detections = self._nms(
            boxes_yx, labels, iou_threshold=self._iou_threshold,
            score_threshold=self._score_threshold,
        )
        return _format_mask(mask, self._mask_output), detections

    def prepare_input(self, images) -> torch.Tensor:
        """Stage a host batch on the device: NumPy goes through pinned host
        memory with a non-blocking upload; a tensor is moved as it is."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.device == self.device:
            return images
        if self.device.type == "cuda" and images.device.type == "cpu":
            images = images.pin_memory()
        return images.to(self.device, non_blocking=True)

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
        """(formatted mask, detections) as device tensors, not waited for."""
        return self._forward(self.prepare_input(images))

    def predict(self, images):
        """NumPy-in/NumPy-out, applying the optional host-side
        background-box filter (reference layers.py:165-166).  A bf16 mask
        comes back as float32 NumPy; 'class_map' returns the uint8 map."""
        from ssdseglib_torch.utils.serving import format_outputs

        mask, det = self(images)
        return format_outputs(mask, det, self._suppress_background)

    def predict_batched(self, images, batch: int = 16):
        """Serve any number of images at one batch size, with `predict`'s
        NumPy conventions -- see `utils.serving.predict_batched_chunks` for
        the chunk / repeat-pad / slice protocol and why repeat-padding
        keeps the batch-global segmentation suppression exact."""
        from ssdseglib_torch.utils.serving import (
            format_outputs,
            predict_batched_chunks,
        )

        mask, det = predict_batched_chunks(images, batch, self)
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
    ) -> InferenceModel:
        """Args:
            model_trained: the trained `SsdSegModel`, or its state_dict.
            compute_dtype: 'bfloat16' for the serving fast path.
            fused_backbone: BN-folded forward through the fused MBConv kernel.
            mask_output: 'float32' | 'bfloat16' | 'class_map'.
            device: where the model serves; the card unless the caller
                asks for the CPU.
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
