"""The port facade's `tf.data` bridge and `tf.keras.models.load_model` shim
(`ssdseglib_torch.compat`), here where TensorFlow imports, at 96x128 over 3
synthetic PNG / CSV triples on the CPU; and that importing the facade loads
neither TensorFlow nor h5py nor anything of JAX.

The bridge is held to the port's own coder called without TensorFlow: the
packed wire's elements are its `read_and_encode_packed` arrays bit for bit,
the f32 wire's its `read_and_encode` arrays.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssdseglib_torch.compat as ssdseglib
from ssdseglib_torch.compat import models as compat_models
from tests import torch_compat_recipe as recipe
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_KEY = ssdseglib.datacoder.COLOR_AUG_SEED_KEY


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def triples(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("triples")
    rng = np.random.default_rng(3)
    h, w = recipe.INPUT_IMAGE_SHAPE[:2]
    out = []
    for i in range(3):
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), dtype=np.uint8)
        label = int(rng.integers(1, 4))
        y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = label
        paths = (str(root / f"img{i}.png"), str(root / f"mask{i}.png"), str(root / f"boxes{i}.csv"))
        Image.fromarray(image).save(paths[0])
        Image.fromarray(mask).save(paths[1])
        with open(paths[2], "w") as f:
            f.write(f"{label},{x0},{y0},{x0 + w // 3 - 1},{y0 + h // 3 - 1}\r\n")
        out.append(paths)
    return out


def _coder():
    kwargs, _ = recipe.default_boxes(ssdseglib)
    return ssdseglib.datacoder.DataEncoderDecoder(
        num_classes=4, image_shape=recipe.INPUT_IMAGE_SHAPE[:2],
        center_x_boxes_default=kwargs["center_x_boxes_default"],
        center_y_boxes_default=kwargs["center_y_boxes_default"],
        width_boxes_default=kwargs["width_boxes_default"],
        height_boxes_default=kwargs["height_boxes_default"],
        iou_threshold=0.5, device="cpu")


def _dataset(tf, coder, triples):
    return (tf.data.Dataset.from_tensor_slices(tuple(list(p) for p in zip(*triples)))
            .map(coder.read_and_encode)
            .batch(3)
            .map(ssdseglib.datacoder.augmentation_rgb_channels))


def test_packed_wire_elements_and_the_jitter_tag(tf, triples):
    """The packed wire (the default): uint8 images, class maps and label
    indices, f32 offsets, and the per-batch seed tag; the elements are the
    coder's packed arrays; `fit` takes the tagged batches, jitter deferred."""
    n = recipe.n_anchors(ssdseglib)
    ds = _dataset(tf, _coder(), triples)
    images_spec, targets_spec = ds.element_spec
    assert images_spec.dtype == tf.uint8 and tuple(images_spec.shape[1:]) == (96, 128, 3)
    assert targets_spec["output-mask"].dtype == tf.uint8
    assert tuple(targets_spec["output-mask"].shape[1:]) == (96, 128)
    assert targets_spec["output-labels"].dtype == tf.uint8
    assert tuple(targets_spec["output-labels"].shape[1:]) == (n,)
    assert targets_spec["output-boxes"].dtype == tf.float32
    assert targets_spec[SEED_KEY].dtype == tf.int32

    images, targets = next(iter(ds.as_numpy_iterator()))
    plain = [_coder().read_and_encode_packed(*t) for t in triples]
    for i, name in enumerate(("output-mask", "output-labels", "output-boxes")):
        np.testing.assert_array_equal(targets[name], np.stack([p[i + 1] for p in plain]))
    np.testing.assert_array_equal(images, np.stack([p[0] for p in plain]))
    kind, flat = compat_models._pack_host_batch(images, targets)
    assert kind == (True, True, True) and len(flat) == 5

    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    recipe.compile_like_the_notebook(ssdseglib, model)
    history = model.fit(ds, epochs=1, verbose=0)
    assert np.isfinite(history.history["loss"]).all()


def test_f32_wire_elements(tf, triples, monkeypatch):
    """SSDSEGLIB_PACKED_PIPELINE=0: f32 images and one-hot targets, the
    coder's `read_and_encode` arrays, the jitter on the host, no tag."""
    monkeypatch.setenv("SSDSEGLIB_PACKED_PIPELINE", "0")
    coder = _coder()
    ds = _dataset(tf, coder, triples)
    images_spec, targets_spec = ds.element_spec
    assert images_spec.dtype == tf.float32
    assert targets_spec["output-mask"].dtype == tf.float32
    assert tuple(targets_spec["output-mask"].shape[1:]) == (96, 128, 4)
    assert targets_spec["output-labels"].shape[-1] == 4
    assert SEED_KEY not in targets_spec

    images, targets = next(iter(ds.as_numpy_iterator()))
    plain = [_coder().read_and_encode(*t) for t in triples]
    for name in ("output-mask", "output-labels", "output-boxes"):
        np.testing.assert_array_equal(targets[name], np.stack([p[1][name] for p in plain]))
    unjittered = np.stack([p[0] for p in plain])
    assert images.shape == unjittered.shape and not np.array_equal(images, unjittered)
    assert images.min() >= 0.0 and images.max() <= 255.0
    kind, flat = compat_models._pack_host_batch(images, targets)
    assert kind == (True, False, False) and len(flat) == 4


def test_read_image_inside_dataset_map(tf, triples):
    ds = tf.data.Dataset.from_tensor_slices([t[0] for t in triples]).map(
        ssdseglib.datacoder.read_image)
    for got, t in zip(ds.as_numpy_iterator(), triples):
        np.testing.assert_array_equal(got, ssdseglib.datacoder.read_image(t[0]))


def test_load_model_shim_loads_the_facade_s_files(tf, tmp_path, monkeypatch):
    """The shim (installed only with TensorFlow imported) loads a file
    written by the facade into its `KerasStyleModel` and hands any other
    file to the loader it wraps; a second install leaves it alone."""
    foreign = []
    monkeypatch.setattr(tf.keras.models, "load_model",
                        lambda filepath, *args, **kwargs: foreign.append(filepath) or "keras")
    compat_models.install_tf_load_model_shim()
    shim = tf.keras.models.load_model
    compat_models.install_tf_load_model_shim()
    assert tf.keras.models.load_model is shim and shim._ssdseglib_shim

    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    path = str(tmp_path / "model.keras")
    model.save(path)
    loaded = tf.keras.models.load_model(path, device="cpu")
    assert isinstance(loaded, compat_models.KerasStyleModel)
    for key, value in model.variables.items():
        assert torch.equal(loaded.variables[key], value), key
    other = str(tmp_path / "other.keras")
    with open(other, "wb") as f:
        f.write(b"not a zip")
    assert tf.keras.models.load_model(other) == "keras" and foreign == [other]


def test_importing_the_facade_loads_no_tensorflow_h5py_or_jax():
    code = (
        "import sys, ssdseglib_torch.compat\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('tensorflow', 'h5py', "
        "'jax', 'jaxlib', 'flax', 'optax', 'ssdseglib_tpu', 'ssdseglib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
