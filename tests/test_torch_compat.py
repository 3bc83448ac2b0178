"""The port's Keras-style facade (`ssdseglib_torch.compat`) against the JAX
package's (`ssdseglib`), at 96x128 on the CPU.

The JAX facade runs in one subprocess for the file
(tests/torch_compat_jax_side.py, whose docstring gives the reason), started
by the first test that asks for it; it writes its `.keras` files and results
into a directory that this process reads, and the port's side runs here
meanwhile.  Both sides take notebook 03's recipe from
tests/torch_compat_recipe.py.

Tolerances:
- the port's `fit` from the JAX facade's "before" file against the JAX
  facade's `fit` (history, then raw outputs): rtol 2e-3 / atol 2e-4 in f32,
  or, where the port's own spread between two thread counts is larger,
  twice that spread (the test's docstring says why);
- raw outputs of a `.keras` file written by one facade and loaded by the
  other, against the writer's: 1e-5;
- serving from the JAX facade's "after" file: masks 2e-3, detections the
  same rows and labels, scores and boxes within 1e-4;
- the packing helpers and the content cache's keys: identical bytes; the
  one-hot unpack bit for bit, the injected jitter 1e-3 on [0, 255] (the
  bar of tests/test_torch_color.py).
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ssdseglib_torch.compat as ssdseglib
from ssdseglib_torch.compat import models as compat_models
from tests import torch_compat_recipe as recipe
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE_TIMEOUT_S = 600
FIT_GATE = dict(rtol=2e-3, atol=2e-4)
FILE_GATE = dict(rtol=1e-5, atol=1e-5)


class JaxSide:
    """The JAX facade's subprocess and the files it writes."""

    def __init__(self, workdir: str) -> None:
        self.workdir = workdir
        self._log = open(os.path.join(workdir, "jax_side.log"), "w")
        self._proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_compat_jax_side.py"), workdir],
            cwd=ROOT, stdout=self._log, stderr=subprocess.STDOUT)
        self._deadline = time.monotonic() + JAX_SIDE_TIMEOUT_S
        self._results = None

    def _failed(self) -> str:
        self._log.flush()
        with open(os.path.join(self.workdir, "jax_side.log")) as f:
            return f"the JAX facade's script failed (rc {self._proc.returncode}):\n{f.read()[-4000:]}"

    def file(self, name: str) -> str:
        """The path of ``name`` once the script has written it."""
        path = os.path.join(self.workdir, name)
        while not os.path.exists(path):
            if self._proc.poll() is not None and not os.path.exists(path):
                pytest.fail(self._failed())
            if time.monotonic() > self._deadline:
                pytest.fail(f"no {name} after {JAX_SIDE_TIMEOUT_S} s")
            time.sleep(0.2)
        return path

    def results(self):
        """(arrays, history and summary lines) once the script has ended."""
        if self._results is None:
            try:
                rc = self._proc.wait(timeout=max(1.0, self._deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"the JAX facade's script did not end in {JAX_SIDE_TIMEOUT_S} s")
            if rc != 0:
                pytest.fail(self._failed())
            with np.load(self.file("results.npz")) as data:
                arrays = {k: data[k] for k in data.files}
            with open(self.file("results.json")) as f:
                self._results = arrays, json.load(f)
        return self._results

    def wire(self):
        with np.load(self.file("wire.npz")) as data:
            return {k: data[k] for k in data.files}

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait(timeout=30)
        self._log.close()


def _port_model_with_random_statistics():
    """The port facade's initial model (seed 1993) with random BatchNorm
    statistics, so a file written from it carries statistics that matter."""
    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    gen = torch.Generator().manual_seed(5)
    variables = {k: (torch.rand(v.shape, generator=gen) + 0.5
                     if k.endswith(("running_mean", "running_var")) else v)
                 for k, v in model.variables.items()}
    model.set_variables(variables)
    return model


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the JAX facade's subprocess, the port model whose `.keras` file it
    loads)."""
    workdir = str(tmp_path_factory.mktemp("compat"))
    port = _port_model_with_random_statistics()
    port.save(os.path.join(workdir, "port.keras"))
    side = JaxSide(workdir)
    yield side, port
    side.close()


@pytest.fixture(scope="module")
def data():
    return recipe.packed_batches(recipe.n_anchors(ssdseglib))


def _serving(model, suppress: bool):
    return recipe.builder(ssdseglib).get_model_for_inference(
        model_trained=model, suppress_background_boxes=suppress, device="cpu", **recipe.SERVE)


# -- the facade flow -------------------------------------------------------------

def _fit_from(path, data, threads: int):
    """The port's facade from a `.keras` file through `compile` and `fit`,
    on ``threads`` torch threads: (history, predict, __call__)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        model = compat_models.load_model(path, device="cpu")
        recipe.compile_like_the_notebook(ssdseglib, model)
        history = model.fit(data, epochs=recipe.EPOCHS, validation_data=data, verbose=0)
        images = recipe.eval_images()
        return history.history, model.predict([images]), model(images)
    finally:
        torch.set_num_threads(before)


def _meets(name, got, want, spread) -> None:
    """``got`` within FIT_GATE of ``want``, or within twice the port's own
    ``spread`` between two thread counts (and FIT_GATE's atol) where that
    noise is the larger."""
    got, want, spread = (np.asarray(a, np.float64) for a in (got, want, spread))
    gate = FIT_GATE["atol"] + FIT_GATE["rtol"] * np.abs(want)
    noise = FIT_GATE["atol"] + 2.0 * float(spread.max())
    worst = float((np.abs(got - want) - np.maximum(gate, noise)).max())
    assert worst <= 0.0, (name, float(np.abs(got - want).max()), float(spread.max()))


def test_fit_from_the_jax_before_file_meets_the_jax_fit(jax_side, data):
    """(i) The JAX facade's "before" file through the port's `compile` /
    `fit`: the history and the trained raw outputs meet the JAX facade's at
    FIT_GATE, except where the port's own fit on one thread instead of two
    (only the summation order changes) moves them more: then within twice
    that spread, measured here.  The box outputs are such a place: Adam
    turns the sign of each noise-level gradient into a whole learning-rate
    step, and after these four steps that moves them ~2e-3."""
    side, _ = jax_side
    path = side.file("before.keras")
    history, predicted, called = _fit_from(path, data, threads=2)
    one_history, one_thread, _ = _fit_from(path, data, threads=1)
    arrays, jax = side.results()
    assert set(history) == set(jax["history"])
    for key, values in jax["history"].items():
        assert len(history[key]) == recipe.EPOCHS
        _meets(key, history[key], values, np.subtract(history[key], one_history[key]))
    for got, one, name in zip(predicted, one_thread, "mlb"):
        assert float(np.abs(got - one).max()) < 1e-2  # the noise stays small
        _meets(name, got, arrays[f"predict/{name}"], got - one)
    for got, want in zip(called, predicted):
        np.testing.assert_array_equal(got, want)
    assert history["loss"][-1] < history["loss"][0]


def test_the_jax_after_file_gives_the_jax_outputs(jax_side):
    """(ii) The JAX facade's trained file, loaded by the port's facade."""
    side, _ = jax_side
    arrays, _ = side.results()
    model = compat_models.load_model(side.file("after.keras"), device="cpu")
    images = recipe.eval_images()
    for got, name in zip(model.predict([images]), "mlb"):
        np.testing.assert_allclose(got, arrays[f"predict/{name}"], err_msg=name, **FILE_GATE)
    for got, name in zip(model(images), "mlb"):
        np.testing.assert_allclose(got, arrays[f"predict/{name}"], err_msg=name, **FILE_GATE)


def test_the_port_s_file_gives_its_outputs_in_the_jax_facade(jax_side):
    """(iii) A `.keras` file the port's facade wrote, loaded by the JAX
    facade's `load_model` in the same subprocess: written before the
    subprocess starts, so one JAX process serves the whole file."""
    side, port = jax_side
    arrays, _ = side.results()
    for got, name in zip(port.predict([recipe.eval_images()]), "mlb"):
        np.testing.assert_allclose(arrays[f"port/{name}"], got, err_msg=name, **FILE_GATE)


def test_summary_lines_match_the_jax_facade(jax_side):
    _, jax = jax_side[0].results()
    lines = []
    recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu").summary(print_fn=lines.append)
    assert lines == jax["summary"]
    assert lines[-3:] == ["Total params: 4,047,408", "Trainable params: 4,009,920",
                          "Non-trainable params: 37,488"]


@pytest.mark.parametrize("suppress", [False, True])
def test_serving_meets_the_jax_facade(jax_side, suppress):
    """`get_model_for_inference(model_trained=<loaded after file>)`:
    `predict` on the batch and `__call__` on its first image; with
    ``suppress_background_boxes`` the background rows go and the batch
    structure with them, in both calls."""
    side, _ = jax_side
    arrays, _ = side.results()
    serving = _serving(compat_models.load_model(side.file("after.keras"), device="cpu"),
                       suppress)
    images = recipe.eval_images()
    mask, det = serving.predict(images)
    _, call_det = serving(images[:1], training=False)
    tag = f"serve{int(suppress)}"
    np.testing.assert_allclose(mask, arrays[f"{tag}/mask"], rtol=2e-3, atol=2e-3)
    for got, want in ((det, arrays[f"{tag}/det"]), (call_det, arrays[f"{tag}/call_det"])):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0, atol=1e-4)
    if suppress:
        assert det.ndim == 2 and (det[:, 0] > 0).all()
    else:
        assert det.shape == (recipe.BATCH, 10, 6)
    assert (det[..., 1] > 0).sum() > 0  # rows to compare


# -- the wire ------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(recipe.wire_cases())),
                         ids=[name for name, _, _ in recipe.wire_cases()])
def test_packing_helpers_give_the_jax_facade_s_bytes(jax_side, case):
    want = jax_side[0].wire()
    _, images, targets = recipe.wire_cases()[case]
    kind, flat = compat_models._pack_host_batch(images, targets)
    assert kind == tuple(bool(k) for k in want[f"{case}/kind"])
    assert len(flat) == len([k for k in want if k.startswith(f"{case}/flat")])
    for j, got in enumerate(flat):
        expected = want[f"{case}/flat{j}"]
        assert np.asarray(got).dtype == expected.dtype and np.asarray(got).shape == expected.shape
        assert np.asarray(got).tobytes() == expected.tobytes()
    for name in ("output-mask", "output-labels"):
        packed = compat_models._pack_one_hot(targets[name])
        expected = want[f"{case}/one_hot/{name}"]
        assert (packed is None) == (expected.size == 0)
        if packed is not None:
            assert packed.dtype == expected.dtype and packed.tobytes() == expected.tobytes()
    packed = compat_models._pack_images_u8(images)
    expected = want[f"{case}/images_u8"]
    assert (packed is None) == (expected.size == 0)
    if packed is not None:
        assert packed.tobytes() == expected.tobytes()


def test_content_cache_keys_are_the_jax_facade_s(jax_side):
    """Equal keys for equal bytes (the JAX facade's own digests), none for a
    seeded batch under either key mode; a hit returns the inserted batch."""
    want = jax_side[0].wire()
    cache = compat_models._DeviceBatchCache(key_mode="content")
    for case, (_, images, targets) in enumerate(recipe.wire_cases()):
        key, refs = cache.key_refs(images, targets)
        assert refs is None
        assert ("" if key is None else key[1]) == str(want[f"{case}/content_key"])
    _, images, targets = recipe.wire_cases()[0]
    key, _ = cache.key_refs(images, targets)
    again, _ = cache.key_refs(images.copy(), {k: v.copy() for k, v in targets.items()})
    assert again == key
    cache.insert(key, None, (True, True, False), (torch.zeros(4),))
    assert cache.get(again)[0] == (True, True, False)
    _, images, seeded = recipe.wire_cases()[-1]
    assert compat_models._DeviceBatchCache(key_mode="id").key_refs(images, seeded) == (None, None)


def test_unflatten_rebuilds_the_one_hot_and_applies_the_jitter(jax_side, monkeypatch):
    """The packed class maps one-hot bit for bit as the JAX facade's; the
    deferred jitter is applied from the seed leaf (the JAX facade's four
    draws injected into the port's color op)."""
    from ssdseglib_torch.ops import color as color_ops

    want = jax_side[0].wire()
    _, images, targets = recipe.wire_cases()[-1]
    kind, flat = compat_models._pack_host_batch(images, targets)
    assert kind == (True, True, True)
    scalars = torch.from_numpy(want["unflatten/scalars"])
    seeds = []

    def draws(generator):
        seeds.append(generator.initial_seed())
        return scalars

    monkeypatch.setattr(color_ops, "draw_rgb_scalars", draws)
    got, got_targets = compat_models.make_unflatten(kind, 4)(*flat)
    assert seeds == [424242]
    np.testing.assert_array_equal(got_targets["output-mask"].numpy(), want["unflatten/mask"])
    np.testing.assert_array_equal(got_targets["output-labels"].numpy(), want["unflatten/labels"])
    np.testing.assert_array_equal(got_targets["output-boxes"].numpy(), flat[3])
    np.testing.assert_allclose(got.numpy(), want["unflatten/images"], rtol=0, atol=1e-3)
    plain, _ = compat_models.make_unflatten(kind[:2] + (False,), 4)(*flat[:4])
    np.testing.assert_array_equal(plain.numpy(), want["unflatten/plain"])
    assert not np.array_equal(got.numpy(), plain.numpy())  # the jitter changed the pixels
    # a class outside [0, C) gives an all-zero row, as tf.one_hot does
    _, outside = compat_models.make_unflatten((True, True, False), 4)(
        flat[0], np.full_like(flat[1], 7), flat[2], flat[3])
    assert float(outside["output-mask"].abs().sum()) == 0.0


# -- the port's side alone ----------------------------------------------------------

def _fit(data, cache_batches, epochs=2):
    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    recipe.compile_like_the_notebook(ssdseglib, model)
    history = model.fit(data, epochs=epochs, verbose=0, cache_batches=cache_batches)
    return model, history


def test_a_resident_dataset_uploads_once_and_gives_the_uncached_bits(data, monkeypatch):
    from ssdseglib_torch.data import pipeline

    uploads = []
    upload = pipeline.upload_batch
    monkeypatch.setattr(pipeline, "upload_batch",
                        lambda batch, device: uploads.append(len(batch)) or upload(batch, device))
    cached, cached_history = _fit(data, cache_batches=True)
    assert uploads == [4, 4]  # the first epoch's two batches, nothing after
    uploads.clear()
    plain, plain_history = _fit(data, cache_batches=False)
    assert uploads == [4, 4] * 2
    assert cached_history.history == plain_history.history
    for key, value in plain.variables.items():
        assert torch.equal(cached.variables[key], value), key


def test_save_npz_and_set_variables_round_trip(tmp_path, data):
    model, _ = _fit(data[:1], cache_batches=False, epochs=1)
    path = str(tmp_path / "weights" / "trained.npz")
    model.save(path)
    from ssdseglib_torch.checkpoint import load_params_npz

    again = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    again.set_variables(load_params_npz(path))
    images = recipe.eval_images()
    for got, want in zip(again(images), model(images)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="do not fit"):
        again.set_variables({"not-a-layer.weight": torch.zeros(1)})


def test_keras_files_without_h5py_raise_the_named_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    with pytest.raises(ImportError, match="needs h5py"):
        model.save(str(tmp_path / "model.keras"))


def test_compile_and_fit_refusals(data):
    model = recipe.builder(ssdseglib).get_model_for_training(
        segmentation_dilation_rates=recipe.DILATIONS, device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        model.fit(data)
    with pytest.raises(ValueError, match="loss dict"):
        model.compile(optimizer=1e-3)
    with pytest.raises(ValueError, match="compute_dtype"):
        model.compile(loss={"output-boxes": ssdseglib.losses.localization_loss},
                      compute_dtype="float16")
    # the facade's trainer has no anchors: only its own objective may run
    from ssdseglib_torch.config import TrainConfig
    from ssdseglib_torch.train import Trainer

    with pytest.raises(ValueError, match="anchors"):
        Trainer(model=model.module, anchors=None, config=TrainConfig(), device="cpu")
    assert compat_models._learning_rate_of(None) == 1e-3
    assert compat_models._learning_rate_of(type("Adam", (), {"learning_rate": 2e-4})()) == 2e-4


def test_entry_points_default_to_the_card():
    """The facade's builders and `load_model` run on the card unless the
    caller asks for the CPU; without a card they raise instead of moving to
    the CPU."""
    for fn in (compat_models._CompatBuilderMixin.get_model_for_training,
               compat_models._CompatBuilderMixin.get_model_for_inference,
               compat_models.load_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    builder = recipe.builder(ssdseglib)
    if torch.cuda.is_available():
        model = builder.get_model_for_training(segmentation_dilation_rates=recipe.DILATIONS)
        assert model.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            builder.get_model_for_training(segmentation_dilation_rates=recipe.DILATIONS)
