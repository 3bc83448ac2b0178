"""JAX side of tests/test_torch_compat.py: the JAX package's facade
(``ssdseglib``) through notebook 03's recipe at 96x128, in a process of its
own.

    python tests/torch_compat_jax_side.py WORKDIR

The facade's module name, ``ssdseglib``, is the reference package's too,
which the ``reference`` fixture (tests/conftest.py) imports in the test
process; so, as tests/test_ssdseglib_compat.py does, the facade runs here.
In WORKDIR the test process has written ``port.keras`` (the port facade's
weights) before starting this script, which writes, in this order:

- ``wire.npz``: the packing helpers' kinds and bytes on
  `torch_compat_recipe.wire_cases`, the content cache's keys, `make_unflatten`
  of the seeded case and the four jitter scalars of its seed;
- ``before.keras``: the facade's initial weights (key 1993), moved into
  place whole once written;
- ``after.keras`` and ``results.npz``: after `compile` with notebook 03's
  dicts and `fit` for EPOCHS epochs of the two packed batches with
  ``validation_data``: the history, `predict`'s raw outputs, `summary`
  lines, both serving modes' `predict` / `__call__`, and the raw outputs of
  ``port.keras`` loaded into this facade.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import ssdseglib  # noqa: E402
from tests import torch_compat_recipe as recipe  # noqa: E402


def wire(path: str) -> None:
    from ssdseglib.models import (
        _DeviceBatchCache,
        _pack_host_batch,
        _pack_images_u8,
        _pack_one_hot,
        make_unflatten,
    )
    out = {}
    cache = _DeviceBatchCache(key_mode="content")
    for i, (_, images, targets) in enumerate(recipe.wire_cases()):
        kind, flat = _pack_host_batch(images, targets)
        out[f"{i}/kind"] = np.asarray(kind)
        for j, a in enumerate(flat):
            out[f"{i}/flat{j}"] = np.asarray(a)
        for name in ("output-mask", "output-labels"):
            packed = _pack_one_hot(targets[name])
            out[f"{i}/one_hot/{name}"] = np.asarray([] if packed is None else packed)
        packed = _pack_images_u8(images)
        out[f"{i}/images_u8"] = np.asarray([] if packed is None else packed)
        key, _ = cache.key_refs(images, targets)
        out[f"{i}/content_key"] = np.asarray("" if key is None else key[1])
    # the seeded pre-packed case through the unpack, and its jitter draws
    _, images, targets = recipe.wire_cases()[-1]
    kind, flat = _pack_host_batch(images, targets)
    unpacked, unpacked_targets = make_unflatten(kind, 4)(*flat)
    out["unflatten/images"] = np.asarray(unpacked)
    out["unflatten/mask"] = np.asarray(unpacked_targets["output-mask"])
    out["unflatten/labels"] = np.asarray(unpacked_targets["output-labels"])
    out["unflatten/plain"] = np.asarray(make_unflatten(kind[:2] + (False,), 4)(*flat[:4])[0])
    # the four scalars the JAX jitter draws from the seed (as
    # tests/test_torch_color.py::jax_rgb_scalars re-derives them)
    ranges = ((-0.05, 0.05), (0.95, 1.05), (0.90, 1.10), (-0.10, 0.10))
    keys = jax.random.split(jax.random.key(int(flat[4])), 4)
    out["unflatten/scalars"] = np.asarray(
        [float(jax.random.uniform(k, (), minval=low, maxval=high))
         for k, (low, high) in zip(keys, ranges)], np.float32)
    np.savez(path, **out)


def main(workdir: str) -> None:
    wire(os.path.join(workdir, "wire.npz"))

    images = recipe.eval_images()
    port = ssdseglib.models.load_model(os.path.join(workdir, "port.keras"))
    out = {"port/" + k: v for k, v in zip("mlb", port.predict([images]))}

    builder = recipe.builder(ssdseglib)
    model = builder.get_model_for_training(segmentation_dilation_rates=recipe.DILATIONS)
    # the facade's own initialisation (key 1993), compiled once: run op by op
    # it takes tens of seconds on the CPU
    model.set_variables(jax.jit(model._trainable.init)(jax.random.key(1993)))
    summary = []
    model.summary(print_fn=summary.append)
    model.save(os.path.join(workdir, "before.tmp.keras"))
    os.replace(os.path.join(workdir, "before.tmp.keras"), os.path.join(workdir, "before.keras"))

    recipe.compile_like_the_notebook(ssdseglib, model)
    data = recipe.packed_batches(recipe.n_anchors(ssdseglib))
    history = model.fit(data, epochs=recipe.EPOCHS, validation_data=data, verbose=0)
    model.save(os.path.join(workdir, "after.keras"))

    # `predict` is the facade's compiled forward; `__call__` computes the same
    # function op by op (tens of seconds here), so it is left out
    out.update({"predict/" + k: v for k, v in zip("mlb", model.predict([images]))})
    for suppress in (False, True):
        serving = builder.get_model_for_inference(
            model_trained=model, suppress_background_boxes=suppress, **recipe.SERVE)
        mask, det = serving.predict(images)
        out[f"serve{int(suppress)}/mask"], out[f"serve{int(suppress)}/det"] = mask, det
        out[f"serve{int(suppress)}/call_det"] = serving(images[:1], training=False)[1]
    np.savez(os.path.join(workdir, "results.npz"), **out)
    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump({"history": history.history, "summary": summary}, f)
    print("JAX_SIDE_OK")


if __name__ == "__main__":
    main(sys.argv[1])
