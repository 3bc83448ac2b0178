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

`DataEncoderDecoder` keeps the reference constructor/method surface
(num_classes, image_shape, per-coordinate anchor arrays, iou_threshold,
standard deviations, `read_and_encode`, `decode_to_centroids`,
`decode_to_corners`); its encoding runs on the coder's device (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import csv as _csv
import hashlib
import io
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssdseglib_torch.boxes import (
    Anchors,
    coordinates_centroids_to_corners,
    coordinates_corners_to_centroids,
)
from ssdseglib_torch.config import EncodingConfig
from ssdseglib_torch.ops import color as color_ops
from ssdseglib_torch.ops import encoding as enc_ops
from ssdseglib_torch.ops.encoding import make_batch_encoder
from ssdseglib_torch.utils import sample_cache as _sample_cache


def read_image(path_file_image: str) -> np.ndarray:
    """Read an RGB PNG to float32 (H, W, 3) (reference datacoder.py:468-484)."""
    with open(path_file_image, "rb") as f:
        return decode_png_rgb(f.read()).astype(np.float32)


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
        with open(path_or_text, "r", newline="") as f:
            text = f.read()
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


def read_sample(path_file_image: str, path_file_mask: str, path_file_labels_boxes: str,
                max_ground_truth_boxes: int):
    """Host decode of one (image.png, mask.png, labels_boxes.csv) sample into
    fixed-shape arrays: (image (H, W, 3) u8, mask (H, W) u8 class map, and
    the ground truth padded per `pad_ground_truth`)."""
    with open(path_file_image, "rb") as f:
        image = decode_png_rgb(f.read())
    with open(path_file_mask, "rb") as f:
        mask = decode_png_mask(f.read())
    labels, boxes = read_labels_boxes_csv(path_file_labels_boxes)
    return (image, mask) + pad_ground_truth(labels, boxes, max_ground_truth_boxes)


def decoded_cache_key(max_ground_truth_boxes: int, stat):
    """The sample cache's key of a decoded sample (`read_sample`'s value), the
    same for `HostBatcher` and `DataEncoderDecoder`; None when the files'
    identity is unknown (``stat`` None)."""
    return None if stat is None else ("decoded", max_ground_truth_boxes, stat)


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
    shard: Tuple[int, int] = (0, 1),
) -> Callable:
    """Build the device-side batch transform.

    ``fn(generator, images_u8, masks_u8, gt_labels, gt_boxes, gt_valid)``
    -> ``(images_f32, {'output-mask', 'output-labels', 'output-boxes'})``
    where images are (B, H, W, 3) uint8, masks (B, H, W) uint8 class maps
    and the ground truth is padded per `pad_ground_truth`; tensors or NumPy
    arrays, computed on ``device``.  ``generator`` is a ``torch.Generator``
    (on ``device`` or on the CPU) and is read only when an augmentation is
    on: per sample one flip coin, per batch the four color scalars.
    ``shard = (index, count)``: the batches are slice ``index`` of ``count``
    equal slices of a global batch (data parallelism), and the coins are
    drawn for the whole global batch and sliced, so every rank's generator
    advances alike and each sample gets the coin it gets in one process.

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
            b, (index, count) = len(images_u8), shard
            coins = torch.rand(b * count, generator=generator, device=generator.device)
            flip = coins[index * b:(index + 1) * b] >= 0.5
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


class DataEncoderDecoder:
    """Mirror of the reference `DataEncoderDecoder` (datacoder.py:5-432).

    Accepts anchors as corners, centroids, or both (same validation rules);
    `read_and_encode` does host IO + a single-sample encode on ``device``;
    `decode_to_centroids` / `decode_to_corners` invert the encoding.  The
    horizontal flip draws ``numpy.random.default_rng(seed).uniform() >= 0.5``
    once per sample, in call order, as the JAX package's coder does.
    """

    def __init__(
        self,
        num_classes: int,
        image_shape: Tuple[int, int],
        xmin_boxes_default=None,
        ymin_boxes_default=None,
        xmax_boxes_default=None,
        ymax_boxes_default=None,
        center_x_boxes_default=None,
        center_y_boxes_default=None,
        width_boxes_default=None,
        height_boxes_default=None,
        iou_threshold: float = 0.5,
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2),
        augmentation_horizontal_flip: bool = False,
        max_ground_truth_boxes: int = 32,
        seed: int = 0,
        device="cuda",
    ) -> None:
        corners = (xmin_boxes_default, ymin_boxes_default,
                   xmax_boxes_default, ymax_boxes_default)
        centroids = (center_x_boxes_default, center_y_boxes_default,
                     width_boxes_default, height_boxes_default)

        if all(c is None for c in centroids):
            if any(c is None for c in corners):
                raise ValueError(
                    "you must pass all default bounding boxes corners coordinates!"
                )
            corners_np = np.stack([np.asarray(c, np.float32) for c in corners], axis=-1)
        elif all(c is None for c in corners):
            if any(c is None for c in centroids):
                raise ValueError(
                    "you must pass all default bounding boxes centroids coordinates!"
                )
            cents = [np.asarray(c, np.float32) for c in centroids]
            corners_np = np.stack(coordinates_centroids_to_corners(*cents), axis=-1)
        elif all(c is not None for c in corners) and all(c is not None for c in centroids):
            corners_np = np.stack([np.asarray(c, np.float32) for c in corners], axis=-1)
        else:
            raise ValueError(
                "you must pass all default bounding boxes centroids coordinates, "
                "or corners coordinates or both!"
            )

        self.anchors = Anchors(
            corners=corners_np,
            centroids=np.stack(coordinates_corners_to_centroids(*corners_np.T), axis=-1),
        )
        # reference-compatible attribute surface
        self.num_classes = num_classes
        self.image_height, self.image_width = image_shape
        self.iou_threshold = iou_threshold
        (
            self.standard_deviation_center_x_offsets,
            self.standard_deviation_center_y_offsets,
            self.standard_deviation_width_offsets,
            self.standard_deviation_height_offsets,
        ) = standard_deviations_centroids_offsets
        self.xmin_boxes_default = self.anchors.xmin
        self.ymin_boxes_default = self.anchors.ymin
        self.xmax_boxes_default = self.anchors.xmax
        self.ymax_boxes_default = self.anchors.ymax
        self.center_x_boxes_default = self.anchors.center_x
        self.center_y_boxes_default = self.anchors.center_y
        self.width_boxes_default = self.anchors.width
        self.height_boxes_default = self.anchors.height
        self.augmentation_horizontal_flip = augmentation_horizontal_flip

        self.config = EncodingConfig(
            num_classes=num_classes,
            image_shape=tuple(image_shape),
            iou_threshold=iou_threshold,
            standard_deviations=tuple(standard_deviations_centroids_offsets),
            max_ground_truth_boxes=max_ground_truth_boxes,
        )
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._encode_batch = make_batch_encoder(self.anchors, self.config, device=self.device)
        self._anchors_centroids = torch.from_numpy(self.anchors.centroids)
        # content fingerprint of the encoding for the shared sample cache,
        # built as the JAX package's: two coders with other anchors or
        # another config must not share encoded entries
        self._encode_fingerprint = hashlib.blake2b(
            corners_np.tobytes()
            + repr((
                num_classes,
                tuple(image_shape),
                iou_threshold,
                tuple(standard_deviations_centroids_offsets),
                max_ground_truth_boxes,
            )).encode(),
            digest_size=8,
        ).hexdigest()

    # -- encoding ---------------------------------------------------------
    def _encode_padded(self, gl, gb, gv, flip: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Encode one padded sample on the coder's device: (labels (N, C) f32
        one-hot, offsets (N, 4) f32) as NumPy.  Padded slots are masked by
        `gv` inside the matcher, so flipping the zero padding rows is
        harmless."""
        if flip:
            gb = flip_boxes_horizontal(torch.from_numpy(gb), float(self.image_width)).numpy()
        labels, offsets = self._encode_batch(gl[None], gb[None], gv[None])
        return labels[0].cpu().numpy(), offsets[0].cpu().numpy()

    def encode_ground_truth(
        self,
        labels: np.ndarray,
        boxes_corners: np.ndarray,
        flip_horizontal: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode one sample's ragged ground truth (reference
        `_encode_ground_truth_labels_boxes`, datacoder.py:177-300, minus the
        file IO).  Returns (labels (N, C), offsets (N, 4))."""
        gl, gb, gv = pad_ground_truth(
            np.asarray(labels, np.int32),
            np.asarray(boxes_corners, np.float32).reshape(-1, 4),
            self.config.max_ground_truth_boxes,
        )
        return self._encode_padded(gl, gb, gv, flip_horizontal)

    def _load_decoded(self, path_file_image, path_file_mask, path_file_labels_boxes):
        """Decoded (image u8, mask u8 map, padded gt) through the
        process-wide sample cache, under the key `HostBatcher` uses too.
        Returns (stat_key_or_None, (image, mask, gl, gb, gv)); cached arrays
        are immutable (callers copy before flipping)."""
        cache = _sample_cache.global_sample_cache()
        paths = (path_file_image, path_file_mask, path_file_labels_boxes)
        stat = cache.stat_key(*paths) if cache.enabled else None
        max_gt = self.config.max_ground_truth_boxes
        key = decoded_cache_key(max_gt, stat)
        value = cache.get(key)
        if value is None:
            value = read_sample(*paths, max_gt)
            cache.put(key, value)
        return stat, value

    def _encode_padded_cached(self, stat, gl, gb, gv, flip: bool):
        """`_encode_padded` through the sample cache, keyed by (sample files,
        flip, encoding fingerprint).  Exactly-one-hot labels are stored as
        uint8 class indices; labels with an all-zero row (a ground-truth
        label outside [0, num_classes)) are stored as f32.
        Returns (labels f32, offsets f32, labels_u8_or_None)."""
        cache = _sample_cache.global_sample_cache()
        key = ("encoded", self._encode_fingerprint, flip, stat) if stat is not None else None
        if key is not None:
            hit = cache.get(key)
            if hit is not None:
                tag, packed, offsets = hit
                if tag == "u8":
                    labels = (packed[..., None]
                              == np.arange(self.num_classes, dtype=packed.dtype)
                              ).astype(np.float32)
                    return labels, offsets, packed
                return packed, offsets, None
        labels, offsets = self._encode_padded(gl, gb, gv, flip)
        one_hot = (((labels.sum(axis=-1) == 1.0).all())
                   and ((labels == 0.0) | (labels == 1.0)).all()
                   and self.num_classes <= 255)
        if one_hot:
            labels_u8 = labels.argmax(axis=-1).astype(np.uint8)
            if key is not None:
                cache.put(key, ("u8", labels_u8, offsets))
            return labels, offsets, labels_u8
        if key is not None:
            cache.put(key, ("f32", labels, offsets))
        return labels, offsets, None

    def _read_and_encode_raw(self, path_file_image, path_file_mask, path_file_labels_boxes):
        """Shared IO + flip + encode: (image u8, mask u8 class map, labels f32,
        offsets f32, labels_u8_or_None)."""
        stat, (image, mask_map, gl, gb, gv) = self._load_decoded(
            path_file_image, path_file_mask, path_file_labels_boxes
        )
        flip = bool(self.augmentation_horizontal_flip and self._rng.uniform() >= 0.5)
        if flip:
            image = image[:, ::-1, :].copy()
            mask_map = mask_map[:, ::-1].copy()
        labels, offsets, labels_u8 = self._encode_padded_cached(stat, gl, gb, gv, flip)
        return image, mask_map, labels, offsets, labels_u8

    def read_and_encode(
        self,
        path_file_image: str,
        path_file_mask: str,
        path_file_labels_boxes: str,
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Host IO + encode for one sample (reference datacoder.py:302-347).

        Returns (image float32 (H, W, 3),
                 {'output-mask' one-hot, 'output-labels', 'output-boxes'}).
        """
        image_u8, mask_map, labels, offsets, _ = self._read_and_encode_raw(
            path_file_image, path_file_mask, path_file_labels_boxes
        )
        # tf.one_hot semantics (reference datacoder.py:330): an out-of-range
        # pixel value gives an all-zero row
        mask = (mask_map[..., None]
                == np.arange(self.num_classes, dtype=mask_map.dtype)).astype(np.float32)
        return image_u8.astype(np.float32), {
            "output-mask": mask,
            "output-labels": labels,
            "output-boxes": offsets,
        }

    def read_and_encode_packed(
        self,
        path_file_image: str,
        path_file_mask: str,
        path_file_labels_boxes: str,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """`read_and_encode` in the packed wire format: (image uint8 (H, W, 3),
        mask uint8 class map (H, W), labels uint8 class indices (N,), offsets
        float32 (N, 4)); each one-hots back to `read_and_encode`'s output.
        Same flip stream as `read_and_encode`."""
        image, mask_map, _, offsets, labels_u8 = self._read_and_encode_raw(
            path_file_image, path_file_mask, path_file_labels_boxes
        )
        if labels_u8 is None:
            raise ValueError(
                "packed pipeline needs exactly-one-hot encoded labels (a "
                "ground-truth label is outside [0, num_classes)); "
                "read_and_encode is the float32 path"
            )
        return image, mask_map, labels_u8, offsets

    # -- decoding ---------------------------------------------------------
    def _offsets_and_anchors(self, offsets_centroids):
        """The offsets as an f32 tensor (NumPy input copied), and the anchor
        centroids on its device."""
        if isinstance(offsets_centroids, torch.Tensor):
            offsets = offsets_centroids.float()
        else:
            offsets = torch.tensor(np.asarray(offsets_centroids), dtype=torch.float32)
        return offsets, self._anchors_centroids.to(offsets.device)

    def decode_to_centroids(
        self, offsets_centroids, output_decoded_centroids_separately: bool = False
    ):
        """Decode ground-truth offsets to centroids (reference
        datacoder.py:349-388), as tensors on the offsets' device."""
        offsets, anchors = self._offsets_and_anchors(offsets_centroids)
        cent = enc_ops.decode_offsets_to_centroids(
            offsets, anchors, self.config.standard_deviations,
            zero_background=True,
        )
        if output_decoded_centroids_separately:
            return cent.unbind(-1)
        return cent

    def decode_to_corners(
        self, offsets_centroids, output_decoded_corners_separately: bool = False
    ):
        """Decode ground-truth offsets to corners (reference
        datacoder.py:390-432), as tensors on the offsets' device."""
        offsets, anchors = self._offsets_and_anchors(offsets_centroids)
        corners = enc_ops.decode_offsets_to_corners(
            offsets, anchors, self.config.standard_deviations,
            zero_background=True,
        )
        if output_decoded_corners_separately:
            return corners.unbind(-1)
        return corners


def augmentation_rgb_channels(image_batch, targets_batch,
                              generator: Optional[torch.Generator] = None):
    """Batch color augmentation (reference datacoder.py:434-466): one random
    hue, saturation, contrast and brightness per batch from ``generator`` (a
    ``torch.Generator`` on the images' device or on the CPU; a fresh one
    seeded from NumPy's default generator when omitted).  Returns (images,
    targets_batch)."""
    images = torch.as_tensor(image_batch, dtype=torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(int(np.random.default_rng().integers(2**31)))
    return color_ops.augmentation_rgb_channels(generator, images), targets_batch
