"""TF-bridge datacoder: the reference `tf.data` recipe over the port's
encoder, the port's counterpart of ssdseglib/datacoder.py.

The reference notebooks build their input pipelines with
`tf.data.Dataset.map(data_reader_encoder.read_and_encode)` and
`.map(ssdseglib.datacoder.augmentation_rgb_channels)` (reference notebook
03 cell 8; reference datacoder.py:302-347, :434-466).  The port's encoder
is host NumPy plus the batch encoder on the coder's device
(`ssdseglib_torch.datacoder`); this module wraps it behind
`tf.numpy_function` so the notebook pipelines run as written, while callers
without TensorFlow tensors get the port's implementation unchanged.
TensorFlow is imported only when a TensorFlow tensor comes in.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

import ssdseglib_torch.datacoder as _impl
from ssdseglib_torch.ops import color as color_ops

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)

#: Packed wire format for the tf.data bridge (default on; disable with
#: SSDSEGLIB_PACKED_PIPELINE=0 for the float32 reference wire):
#: `read_and_encode` emits uint8 images, uint8 class-map masks and uint8
#: label indices instead of float32 one-hot (16x less mask bandwidth
#: through tf.data and the host-to-device copy), and
#: `augmentation_rgb_channels` defers the color jitter to the device by
#: tagging the batch with a per-batch seed that the compat `fit` consumes
#: (`models.make_unflatten`).  The unpacked tensors are rebuilt bit-exactly
#: on the device (exact {0,1} one-hot, reference datacoder.py:247-248,
#: :333); only the jitter's random stream differs from the host path (same
#: distribution, a torch.Generator seeded from the tag).
COLOR_AUG_SEED_KEY = "__ssdseglib-color-aug-seed__"


def _packed_pipeline() -> bool:
    return os.environ.get("SSDSEGLIB_PACKED_PIPELINE", "1") != "0"


def _is_tf_tensor(x) -> bool:
    tf = sys.modules.get("tensorflow")
    return tf is not None and tf.is_tensor(x)


def _as_path(x) -> str:
    if isinstance(x, bytes):
        return x.decode()
    return str(x)


class DataEncoderDecoder(_impl.DataEncoderDecoder):
    """Reference `DataEncoderDecoder` surface (reference datacoder.py:5-432)
    whose `read_and_encode` also works inside `tf.data.Dataset.map`."""

    def read_and_encode(self, path_file_image, path_file_mask, path_file_labels_boxes):
        if not _is_tf_tensor(path_file_image):
            return super().read_and_encode(
                path_file_image, path_file_mask, path_file_labels_boxes
            )

        import tensorflow as tf

        h, w = self.image_height, self.image_width
        n = self.anchors.total_boxes

        if _packed_pipeline():
            # packed wire: u8 image / u8 class-map mask / u8 label indices
            # (one-hot rebuilt bit-exactly on the device by the compat
            # `fit`: models.make_unflatten)
            def _host_packed(pi, pm, pl):
                image, mask, labels, boxes = (
                    _impl.DataEncoderDecoder.read_and_encode_packed(
                        self, _as_path(pi), _as_path(pm), _as_path(pl)
                    )
                )
                return (
                    np.ascontiguousarray(image),
                    np.ascontiguousarray(mask),
                    labels,
                    np.asarray(boxes, np.float32),
                )

            image, mask, labels, boxes = tf.numpy_function(
                _host_packed,
                [path_file_image, path_file_mask, path_file_labels_boxes],
                [tf.uint8, tf.uint8, tf.uint8, tf.float32],
            )
            image.set_shape((h, w, 3))
            mask.set_shape((h, w))
            labels.set_shape((n,))
            boxes.set_shape((n, 4))
            return image, {
                "output-mask": mask,
                "output-labels": labels,
                "output-boxes": boxes,
            }

        def _host(pi, pm, pl):
            image, targets = _impl.DataEncoderDecoder.read_and_encode(
                self, _as_path(pi), _as_path(pm), _as_path(pl)
            )
            return (
                np.asarray(image, np.float32),
                np.asarray(targets["output-mask"], np.float32),
                np.asarray(targets["output-labels"], np.float32),
                np.asarray(targets["output-boxes"], np.float32),
            )

        image, mask, labels, boxes = tf.numpy_function(
            _host,
            [path_file_image, path_file_mask, path_file_labels_boxes],
            [tf.float32, tf.float32, tf.float32, tf.float32],
        )
        image.set_shape((h, w, 3))
        mask.set_shape((h, w, self.num_classes))
        labels.set_shape((n, self.num_classes))
        boxes.set_shape((n, 4))
        return image, {
            "output-mask": mask,
            "output-labels": labels,
            "output-boxes": boxes,
        }


def augmentation_rgb_channels(image_batch, targets_batch):
    """Batch color augmentation usable in `Dataset.map` (reference
    datacoder.py:434-466; notebook 03 cell 8).

    On a packed-pipeline batch (uint8 images from the packed
    `read_and_encode`) the jitter is deferred to the device: the batch
    passes through untouched with a fresh per-batch seed in the targets
    dict (`COLOR_AUG_SEED_KEY`), and the compat `fit` / `evaluate` apply the
    port's `ops/color.py` jitter on the card from that seed, so images
    cross to the device as uint8 (4x fewer bytes)."""
    if not _is_tf_tensor(image_batch):
        return _impl.augmentation_rgb_channels(image_batch, targets_batch)

    import tensorflow as tf

    # deferral is a packed-wire contract: gated on the same knob as
    # read_and_encode, so SSDSEGLIB_PACKED_PIPELINE=0 restores the host
    # jitter even for pipelines whose images are natively uint8
    if (
        _packed_pipeline()
        and image_batch.dtype == tf.uint8
        and isinstance(targets_batch, dict)
    ):
        seed = tf.random.uniform(
            (), minval=0, maxval=2**31 - 1, dtype=tf.int32
        )
        return image_batch, {**targets_batch, COLOR_AUG_SEED_KEY: seed}

    def _host(images):
        generator = torch.Generator().manual_seed(
            int(np.random.default_rng().integers(2**31))
        )
        # f32 cast: a uint8 batch reaching the host path (packed images with
        # targets that are no dict) must not run the HSV round trip in
        # integer arithmetic
        out = color_ops.augmentation_rgb_channels(
            generator, torch.from_numpy(np.asarray(images, np.float32))
        )
        return out.numpy()

    augmented = tf.numpy_function(_host, [image_batch], tf.float32)
    augmented.set_shape(image_batch.shape)
    return augmented, targets_batch


def read_image(path_file_image):
    """Read an RGB PNG to float32, usable in `Dataset.map` (reference
    datacoder.py:468-484; notebook 03 cell 8 ds_test)."""
    if not _is_tf_tensor(path_file_image):
        return _impl.read_image(path_file_image)

    import tensorflow as tf

    def _host(p):
        return np.asarray(_impl.read_image(_as_path(p)), np.float32)

    image = tf.numpy_function(_host, [path_file_image], tf.float32)
    image.set_shape((None, None, 3))
    return image
