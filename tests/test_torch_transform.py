"""The port's device-side batch transform (ssdseglib_torch/datacoder.py)
against ssdseglib_tpu/datacoder.py on the CPU.

The JAX transform runs with a key; the test re-derives the flip mask and the
four color scalars with the same ``jax.random.split`` / ``uniform`` sequence
(datacoder.py: ``key, k_flip = split(key)``, ``uniform(k_flip, (b,)) >=
0.5``, ``key, k_rgb = split(key)``; color.py: the four-way split) and
injects them into the port's pure function.  Tolerances: images 1e-3 on
[0, 255], masks and labels exact, offsets 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu import datacoder as jax_datacoder
from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig as JaxAnchorsConfig
from ssdseglib_tpu.config import EncodingConfig as JaxEncodingConfig

from ssdseglib_torch import datacoder
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import AnchorsConfig, EncodingConfig
from ssdseglib_torch.data.synthetic import generate_dataset
from tests.test_torch_color import jax_rgb_scalars
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)

IMAGE_SHAPE = (96, 128)
BATCH = 6
ANCHORS = dict(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)
ENCODING = dict(num_classes=4, image_shape=IMAGE_SHAPE, iou_threshold=0.35,
                max_ground_truth_boxes=16)


@pytest.fixture(scope="module")
def raw_batch():
    samples = generate_dataset(BATCH, image_shape=IMAGE_SHAPE, seed=5)
    padded = [datacoder.pad_ground_truth(s.labels, s.boxes, 16) for s in samples]
    return (np.stack([s.image for s in samples]), np.stack([s.mask for s in samples]),
            *(np.stack([p[j] for p in padded]) for j in range(3)))


def _jax_draws(key, flip: bool, rgb: bool):
    """The flip mask and color scalars the JAX transform draws from ``key``."""
    mask = scalars = None
    if flip:
        key, k_flip = jax.random.split(key)
        mask = np.asarray(jax.random.uniform(k_flip, (BATCH,)) >= 0.5)
    if rgb:
        key, k_rgb = jax.random.split(key)
        scalars = jax_rgb_scalars(k_rgb)
    return mask, scalars


@pytest.mark.parametrize("flip, rgb", [(False, False), (True, False), (False, True),
                                       (True, True)],
                         ids=["plain", "flip", "rgb", "flip+rgb"])
def test_transform_matches_jax_with_injected_draws(raw_batch, flip, rgb):
    jax_anchors = JaxAnchors.from_config(JaxAnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    jax_fn = jax.jit(jax_datacoder.make_train_batch_transform(
        jax_anchors, JaxEncodingConfig(**ENCODING), flip, rgb))
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    port_fn = datacoder.make_train_batch_transform(
        anchors, EncodingConfig(**ENCODING), flip, rgb, device="cpu")
    flipped_any = False
    for seed in (0, 3):
        key = jax.random.key(seed)
        want_images, want = jax_fn(key, *(jnp.asarray(a) for a in raw_batch))
        mask, scalars = _jax_draws(key, flip, rgb)
        images, targets = port_fn.apply(*raw_batch, mask, scalars)
        assert images.dtype == torch.float32 and tuple(images.shape) == (BATCH, 96, 128, 3)
        np.testing.assert_allclose(images.numpy(), np.asarray(want_images), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(targets["output-mask"].numpy(),
                                      np.asarray(want["output-mask"]))
        np.testing.assert_array_equal(targets["output-labels"].numpy(),
                                      np.asarray(want["output-labels"]))
        np.testing.assert_allclose(targets["output-boxes"].numpy(),
                                   np.asarray(want["output-boxes"]), rtol=1e-5, atol=1e-5)
        assert set(targets) == set(want)
        flipped_any |= bool(flip and mask.any() and not mask.all())
    assert flipped_any == flip  # the flipped cases flip some samples and not others


def test_flip_boxes_uses_the_raw_width():
    boxes = np.array([[[10.0, 5.0, 30.0, 25.0], [0.0, 0.0, 127.0, 95.0]]], np.float32)
    want = np.asarray(jax_datacoder.flip_boxes_horizontal(jnp.asarray(boxes), 128.0))
    got = datacoder.flip_boxes_horizontal(torch.from_numpy(boxes), 128.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [98.0, 5.0, 118.0, 25.0])  # 128 - x, not 127 - x


def test_drawn_transform_is_seeded_and_equals_its_pure_function(raw_batch):
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)
    fn = datacoder.make_train_batch_processor(
        anchors, EncodingConfig(**ENCODING), True, True, device="cpu")
    a_images, a = fn(torch.Generator().manual_seed(2), *raw_batch)
    b_images, b = fn(torch.Generator().manual_seed(2), *raw_batch)
    c_images, _ = fn(torch.Generator().manual_seed(4), *raw_batch)
    assert torch.equal(a_images, b_images) and not torch.equal(a_images, c_images)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the draws, in the order the transform makes them: flips, then colors
    gen = torch.Generator().manual_seed(2)
    flip = torch.rand(BATCH, generator=gen) >= 0.5
    from ssdseglib_torch.ops.color import draw_rgb_scalars

    scalars = draw_rgb_scalars(gen).unbind(0)
    want_images, want = fn.apply(*raw_batch, flip, scalars)
    assert torch.equal(a_images, want_images)
    assert all(torch.equal(a[k], want[k]) for k in a)
    # without augmentation the generator is not read at all
    plain = datacoder.make_train_batch_transform(
        anchors, EncodingConfig(**ENCODING), device="cpu")
    images, targets = plain(None, *raw_batch)
    np.testing.assert_array_equal(images.numpy(), raw_batch[0].astype(np.float32))
    assert targets["output-mask"].sum() == BATCH * 96 * 128


def test_host_helpers_equal_the_jax_package(tmp_path):
    """The copied NumPy helpers: padding, and the CSV reader's path / text
    disambiguation."""
    labels = np.array([1, 2, 3], np.int32)
    boxes = np.arange(12, dtype=np.float32).reshape(3, 4)
    for budget in (2, 5):
        for got, want in zip(datacoder.pad_ground_truth(labels, boxes, budget),
                             jax_datacoder.pad_ground_truth(labels, boxes, budget)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    path = tmp_path / "gt.csv"
    path.write_text("1,2.0,3.0,40.5,50.0\r\n3,0,0,10,10")
    for source in (str(path), "2,1,1,5,5\n1,0,0,3,3", ""):
        for got, want in zip(datacoder.read_labels_boxes_csv(source),
                             jax_datacoder.read_labels_boxes_csv(source)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        datacoder.read_labels_boxes_csv(str(tmp_path / "missing.csv"))


def test_transform_defaults_to_the_card():
    import inspect

    for fn in (datacoder.make_train_batch_transform, datacoder.make_train_batch_processor):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        anchors = Anchors.from_config(AnchorsConfig(**ANCHORS), IMAGE_SHAPE)
        with pytest.raises((RuntimeError, AssertionError)):
            datacoder.make_train_batch_transform(anchors, EncodingConfig(**ENCODING))
