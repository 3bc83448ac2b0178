"""Data reading and the device-side batch transform (PyTorch), counterpart of
the host helpers and the device half of ssdseglib_tpu/datacoder.py.

- **host half**: PNG/CSV decoding into fixed-shape padded NumPy arrays
  (images uint8, masks uint8 class maps, ground truth padded to
  ``max_ground_truth_boxes`` with a validity mask); copies of the JAX
  package's NumPy helpers.
- **device half**: one batched function that flips, color-augments,
  one-hot-encodes the mask and runs the vectorized anchor matcher
  (ops/encoding.py) for the whole batch at once, on the device it was built
  for.

`DataEncoderDecoder` (the reference's constructor/method surface) is not
ported yet.
"""

from __future__ import annotations

import csv as _csv
import io
import os
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import EncodingConfig
from ssdseglib_torch.ops import color as color_ops
from ssdseglib_torch.ops.encoding import make_batch_encoder


def decode_png_rgb(data: bytes) -> np.ndarray:
    """Decode PNG bytes to (H, W, 3) uint8."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def decode_png_mask(data: bytes) -> np.ndarray:
    """Decode a single-channel class-map PNG to (H, W) uint8 (first channel,
    transparency ignored — reference datacoder.py:330-331)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


def read_labels_boxes_csv(path_or_text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a ground-truth CSV of rows (label, xmin, ymin, xmax, ymax).

    The reference splits the raw file on CRLF (datacoder.py:194-196); the
    csv module handles both line endings.
    Returns (labels (G,), boxes (G, 4) corners).
    """
    # path-vs-text disambiguation: treat the string as inline CSV text
    # when it cannot be a path (embedded newline, overlong, empty) or when
    # it is comma-bearing AND no such file exists (commas are legal in
    # file names, so an existing comma-bearing path is still opened) — a
    # plain missing-file path must surface as FileNotFoundError, not as a
    # downstream int() parse error on the path string itself
    looks_like_text = (
        "\n" in path_or_text
        or "\r" in path_or_text
        or len(path_or_text) > 4096
        or path_or_text == ""
        or ("," in path_or_text and not os.path.exists(path_or_text))
    )
    if looks_like_text and "\n" not in path_or_text and "\r" not in path_or_text:
        # single-line comma-bearing string that is not an existing file:
        # if it still looks like a path (csv suffix / path separator), a
        # typo'd path like 'data/run,v2.csv' must fail as a missing file,
        # not as a confusing int() parse error on the path string
        if path_or_text.endswith(".csv") or os.sep in path_or_text:
            raise FileNotFoundError(path_or_text)
    if looks_like_text:
        text = path_or_text
    else:
        text = open(path_or_text, "r", newline="").read()
    labels, boxes = [], []
    for row in _csv.reader(io.StringIO(text.strip())):
        if not row:
            continue
        labels.append(int(row[0]))
        boxes.append([float(v) for v in row[1:5]])
    return (
        np.asarray(labels, dtype=np.int32),
        np.asarray(boxes, dtype=np.float32).reshape(-1, 4),
    )


def pad_ground_truth(
    labels: np.ndarray, boxes: np.ndarray, max_boxes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ragged ground truth to the fixed device budget + validity mask."""
    g = min(len(labels), max_boxes)
    out_labels = np.zeros((max_boxes,), dtype=np.int32)
    out_boxes = np.zeros((max_boxes, 4), dtype=np.float32)
    out_valid = np.zeros((max_boxes,), dtype=bool)
    out_labels[:g] = labels[:g]
    out_boxes[:g] = boxes[:g]
    out_valid[:g] = True
    return out_labels, out_boxes, out_valid


def flip_boxes_horizontal(boxes: torch.Tensor, image_width: float) -> torch.Tensor:
    """Horizontal flip of corner boxes: xmin' = W - xmax, xmax' = W - xmin.

    Uses the raw image width like the reference (datacoder.py:202-203) —
    not width - 1.
    """
    return torch.stack(
        [
            image_width - boxes[..., 2],
            boxes[..., 1],
            image_width - boxes[..., 0],
            boxes[..., 3],
        ],
        dim=-1,
    )


def make_train_batch_transform(
    anchors: Anchors,
    cfg: EncodingConfig,
    augmentation_horizontal_flip: bool = False,
    augmentation_rgb: bool = False,
    device="cuda",
) -> Callable:
    """Build the device-side batch transform.

    ``fn(generator, images_u8, masks_u8, gt_labels, gt_boxes, gt_valid)``
    -> ``(images_f32, {'output-mask', 'output-labels', 'output-boxes'})``
    where images are (B, H, W, 3) uint8, masks (B, H, W) uint8 class maps
    and the ground truth is padded per `pad_ground_truth`; tensors or NumPy
    arrays, computed on ``device``.  ``generator`` is a ``torch.Generator``
    (on ``device`` or on the CPU) and is read only when an augmentation is
    on: per sample one flip coin, per batch the four color scalars.

    ``fn.apply(images_u8, masks_u8, gt_labels, gt_boxes, gt_valid, flip,
    rgb_scalars)`` is the pure function underneath: ``flip`` a (B,) bool
    tensor or None, ``rgb_scalars`` the (hue, saturation, contrast,
    brightness) values or None.
    """
    device = torch.device(device)
    image_width = float(cfg.image_shape[1])
    encode = make_batch_encoder(anchors, cfg, device=device)

    def put(a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a).to(device=device, dtype=dtype, non_blocking=True)

    @torch.no_grad()
    def apply(images_u8, masks_u8, gt_labels, gt_boxes, gt_valid, flip=None,
              rgb_scalars=None):
        images = put(images_u8, torch.float32)
        masks = F.one_hot(put(masks_u8, torch.int64), cfg.num_classes).to(torch.float32)
        gt_boxes = put(gt_boxes, torch.float32)
        if flip is not None:
            flip = put(flip, torch.bool)
            images = torch.where(flip[:, None, None, None], images.flip(2), images)
            masks = torch.where(flip[:, None, None, None], masks.flip(2), masks)
            gt_boxes = torch.where(
                flip[:, None, None], flip_boxes_horizontal(gt_boxes, image_width), gt_boxes
            )
        if rgb_scalars is not None:
            images = color_ops.apply_rgb_augmentation(images, *rgb_scalars)
        labels, offsets = encode(gt_labels, gt_boxes, gt_valid)
        return images, {
            "output-mask": masks,
            "output-labels": labels,
            "output-boxes": offsets,
        }

    def process(generator, images_u8, masks_u8, gt_labels, gt_boxes, gt_valid):
        flip = rgb_scalars = None
        if augmentation_horizontal_flip:
            # per-sample coin with the reference's >= 0.5 convention
            # (datacoder.py:337)
            b = len(images_u8)
            flip = torch.rand(b, generator=generator, device=generator.device) >= 0.5
        if augmentation_rgb:
            rgb_scalars = color_ops.draw_rgb_scalars(generator).to(device).unbind(0)
        return apply(images_u8, masks_u8, gt_labels, gt_boxes, gt_valid, flip, rgb_scalars)

    process.apply = apply
    process.device = device
    return process


def make_train_batch_processor(
    anchors: Anchors,
    cfg: EncodingConfig,
    augmentation_horizontal_flip: bool = False,
    augmentation_rgb: bool = False,
    device="cuda",
) -> Callable:
    """Standalone version of `make_train_batch_transform` (the JAX package
    jits it here; PyTorch runs eagerly, so it is the same function)."""
    return make_train_batch_transform(
        anchors, cfg, augmentation_horizontal_flip, augmentation_rgb, device=device
    )
