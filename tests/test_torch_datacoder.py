"""The port's `DataEncoderDecoder` against the JAX package's on the same PNG /
CSV files, the port's encoding on the CPU: the same flips (NumPy's stream on
both sides), labels and masks exactly, offsets within 1e-6 (XLA and torch
round `log` differently in the last bit; `test_torch_encoding.py`), decoded
boxes within 1e-6 relative and 1e-4 pixels (the offsets' difference through
`exp` and the anchor sizes)."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from ssdseglib_tpu import datacoder as jax_datacoder
from ssdseglib_torch import datacoder
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import AnchorsConfig
from ssdseglib_torch.data.pipeline import HostBatcher
from ssdseglib_torch.data.synthetic import generate_sample
from ssdseglib_torch.ops import color as color_ops
from ssdseglib_torch.utils.sample_cache import global_sample_cache
from tests.torch_parity import two_torch_threads  # noqa: F401

IMAGE_SHAPE = (96, 128)
ANCHORS = Anchors.from_config(AnchorsConfig(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
), IMAGE_SHAPE)
SEED = 5  # its first six draws flip some samples and not others (checked below)


def _write_triple(directory, i, sample):
    paths = [str(directory / f"{i}-{kind}") for kind in ("image.png", "mask.png", "boxes.csv")]
    Image.fromarray(sample.image).save(paths[0])
    Image.fromarray(sample.mask).save(paths[1])
    with open(paths[2], "w") as f:
        for label, (x0, y0, x1, y1) in zip(sample.labels, sample.boxes):
            f.write(f"{int(label)},{x0:.0f},{y0:.0f},{x1:.0f},{y1:.0f}\r\n")
    return tuple(paths)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three synthetic scenes as (image.png, mask.png, boxes.csv) triples."""
    directory = tmp_path_factory.mktemp("samples")
    return [_write_triple(directory, i, generate_sample(i, IMAGE_SHAPE, seed=11,
                                                        non_overlapping=True))
            for i in range(3)]


def _coders(**kwargs):
    args = dict(num_classes=4, image_shape=IMAGE_SHAPE, center_x_boxes_default=ANCHORS.center_x,
                center_y_boxes_default=ANCHORS.center_y, width_boxes_default=ANCHORS.width,
                height_boxes_default=ANCHORS.height, iou_threshold=0.35, **kwargs)
    return jax_datacoder.DataEncoderDecoder(**args), datacoder.DataEncoderDecoder(
        **args, device="cpu")


def _assert_encoded_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])  # labels
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)  # offsets


def test_read_and_encode_six_calls_same_flips(files):
    flips = np.random.default_rng(SEED).uniform(size=6) >= 0.5
    assert flips.any() and not flips.all()
    jax_coder, coder = _coders(augmentation_horizontal_flip=True, seed=SEED)
    for call in range(6):
        triple = files[call % 3]
        image_j, targets_j = jax_coder.read_and_encode(*triple)
        image, targets = coder.read_and_encode(*triple)
        assert image.dtype == np.float32 and image.shape == IMAGE_SHAPE + (3,)
        np.testing.assert_array_equal(image, image_j)
        np.testing.assert_array_equal(targets["output-mask"], targets_j["output-mask"])
        assert targets["output-mask"].dtype == np.float32
        assert targets["output-mask"].shape == IMAGE_SHAPE + (4,)
        _assert_encoded_equal((targets["output-labels"], targets["output-boxes"]),
                              (targets_j["output-labels"], targets_j["output-boxes"]))
        unflipped = datacoder.read_image(triple[0])
        assert np.array_equal(image, unflipped[:, ::-1]) == flips[call] != (
            np.array_equal(image, unflipped))
        assert (targets["output-labels"][:, 1:].sum() > 0)  # matched anchors


def test_read_and_encode_packed_matches_jax_and_unpacked(files):
    jax_coder, coder = _coders(augmentation_horizontal_flip=True, seed=SEED)
    _, unpacked_coder = _coders(augmentation_horizontal_flip=True, seed=SEED)
    for call in range(3):
        packed_j = jax_coder.read_and_encode_packed(*files[call])
        packed = coder.read_and_encode_packed(*files[call])
        image, targets = unpacked_coder.read_and_encode(*files[call])
        for got, want in zip(packed[:3], packed_j[:3]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(packed[3], packed_j[3], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(packed[0].astype(np.float32), image)
        np.testing.assert_array_equal(np.eye(4, dtype=np.float32)[packed[1]],
                                      targets["output-mask"])
        np.testing.assert_array_equal(np.eye(4, dtype=np.float32)[packed[2]],
                                      targets["output-labels"])


def test_out_of_range_label_and_mask_value(tmp_path):
    """A ground-truth label or mask value outside [0, num_classes): all-zero
    one-hot rows (tf.one_hot), and the packed format refused with the JAX
    package's error, which names the port's float32 path in place of the
    JAX package's environment switch."""
    sample = generate_sample(0, IMAGE_SHAPE, seed=11, non_overlapping=True)
    sample.labels[0] = 7
    sample.mask[0, :5] = 9
    triple = _write_triple(tmp_path, 0, sample)
    jax_coder, coder = _coders()
    _, targets_j = jax_coder.read_and_encode(*triple)
    _, targets = coder.read_and_encode(*triple)
    for key in targets:
        np.testing.assert_allclose(targets[key], targets_j[key], rtol=1e-6, atol=1e-6)
    assert (targets["output-labels"].sum(-1) == 0).any()
    assert (targets["output-mask"][0, :5] == 0).all()
    with pytest.raises(ValueError) as jax_error:
        jax_coder.read_and_encode_packed(*triple)
    with pytest.raises(ValueError) as port_error:
        coder.read_and_encode_packed(*triple)
    reason = str(jax_error.value).split("; ")[0]
    assert reason.endswith("outside [0, num_classes))")
    assert str(port_error.value) == reason + "; read_and_encode is the float32 path"


@pytest.mark.parametrize("flip", [False, True])
def test_encode_ground_truth_and_both_decodes(flip):
    sample = generate_sample(4, IMAGE_SHAPE, seed=3)
    jax_coder, coder = _coders()
    want = jax_coder.encode_ground_truth(sample.labels, sample.boxes, flip_horizontal=flip)
    got = coder.encode_ground_truth(sample.labels, sample.boxes, flip_horizontal=flip)
    _assert_encoded_equal(got, want)
    offsets = want[1]
    for method, separately in (("decode_to_centroids", "output_decoded_centroids_separately"),
                               ("decode_to_corners", "output_decoded_corners_separately")):
        expected = np.asarray(getattr(jax_coder, method)(offsets))
        decoded = getattr(coder, method)(offsets)
        assert isinstance(decoded, torch.Tensor) and decoded.dtype == torch.float32
        np.testing.assert_allclose(decoded.numpy(), expected, rtol=1e-6, atol=1e-4,
                                   err_msg=method)
        assert (expected.sum(-1) == 0).any() and (expected.sum(-1) != 0).any()
        parts = getattr(coder, method)(offsets, **{separately: True})
        parts_j = getattr(jax_coder, method)(offsets, **{separately: True})
        assert len(parts) == len(parts_j) == 4
        for a, b in zip(parts, parts_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-4)


def test_anchor_forms_attributes_and_errors():
    corners = dict(xmin_boxes_default=ANCHORS.xmin, ymin_boxes_default=ANCHORS.ymin,
                   xmax_boxes_default=ANCHORS.xmax, ymax_boxes_default=ANCHORS.ymax)
    centroids = dict(center_x_boxes_default=ANCHORS.center_x,
                     center_y_boxes_default=ANCHORS.center_y,
                     width_boxes_default=ANCHORS.width, height_boxes_default=ANCHORS.height)
    for given in (corners, centroids, {**corners, **centroids}):
        args = dict(num_classes=4, image_shape=IMAGE_SHAPE, **given)
        jax_coder = jax_datacoder.DataEncoderDecoder(**args)
        coder = datacoder.DataEncoderDecoder(**args, device="cpu")
        for name in ("num_classes", "image_height", "image_width", "iou_threshold",
                     "standard_deviation_center_x_offsets", "standard_deviation_center_y_offsets",
                     "standard_deviation_width_offsets", "standard_deviation_height_offsets"):
            assert getattr(coder, name) == getattr(jax_coder, name), name
        for name in list(corners) + list(centroids):
            got, want = getattr(coder, name), np.asarray(getattr(jax_coder, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert dataclasses.asdict(coder.config) == dataclasses.asdict(jax_coder.config)
        assert coder._encode_fingerprint == jax_coder._encode_fingerprint
    incomplete = (
        {k: v for k, v in corners.items() if k != "ymax_boxes_default"},
        {k: v for k, v in centroids.items() if k != "width_boxes_default"},
        {**corners, "center_x_boxes_default": ANCHORS.center_x},
    )
    for given in incomplete:
        with pytest.raises(ValueError) as jax_error:
            jax_datacoder.DataEncoderDecoder(4, IMAGE_SHAPE, **given)
        with pytest.raises(ValueError) as port_error:
            datacoder.DataEncoderDecoder(4, IMAGE_SHAPE, **given, device="cpu")
        assert str(port_error.value) == str(jax_error.value)


def test_read_image_matches_jax(files):
    got, want = datacoder.read_image(files[1][0]), jax_datacoder.read_image(files[1][0])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_coder_and_host_batcher_share_decoded_entries(files):
    """The coder's decode lands in the process-wide cache under the key
    `HostBatcher` reads, so the loader's epoch over the same files is all
    hits."""
    cache = global_sample_cache()
    cache.clear()
    _, coder = _coders(max_ground_truth_boxes=32)
    for triple in files:
        coder.read_and_encode(*triple)
    hits = cache.hits
    batches = list(HostBatcher(files, batch_size=3, max_ground_truth_boxes=32, shuffle=False,
                               num_workers=1))
    assert cache.hits - hits == 3 and len(batches) == 1
    np.testing.assert_array_equal(batches[0][0][0], datacoder.read_image(files[0][0]))


def test_augmentation_rgb_channels_takes_a_generator():
    images = np.random.default_rng(0).uniform(0, 255, (2,) + IMAGE_SHAPE + (3,))
    targets = {"output-mask": np.zeros(1)}
    out, passed = datacoder.augmentation_rgb_channels(
        images, targets, generator=torch.Generator().manual_seed(3))
    assert passed is targets and out.dtype == torch.float32 and out.shape == images.shape
    scalars = color_ops.draw_rgb_scalars(torch.Generator().manual_seed(3))
    want = color_ops.apply_rgb_augmentation(torch.as_tensor(images, dtype=torch.float32),
                                            *scalars.unbind(0))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert not torch.equal(out, torch.as_tensor(images, dtype=torch.float32))
    fresh, _ = datacoder.augmentation_rgb_channels(images, targets)
    assert torch.isfinite(fresh).all()


def test_coder_encodes_on_the_card_by_default():
    import inspect

    assert inspect.signature(datacoder.DataEncoderDecoder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            datacoder.DataEncoderDecoder(4, IMAGE_SHAPE, center_x_boxes_default=ANCHORS.center_x,
                                         center_y_boxes_default=ANCHORS.center_y,
                                         width_boxes_default=ANCHORS.width,
                                         height_boxes_default=ANCHORS.height)
