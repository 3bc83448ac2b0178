"""Keras-style model facade over the port's trainer, the port's counterpart of
ssdseglib/models.py.

The reference notebooks drive training through the Keras object API
(reference notebook 03 cells 12-31):

    model = model_builder.get_model_for_training(...)   # cell 12
    model.summary()
    model.compile(optimizer=..., loss={...}, loss_weights={...},
                  metrics={...})                        # cell 14
    history = model.fit(ds_train, epochs=105,
                        validation_data=ds_eval)        # cell 16
    model.save('models/....keras')                      # cell 17
    model_trained = tf.keras.models.load_model(...)     # cell 19
    model_inference = model_builder.get_model_for_inference(
        model_trained=model_trained, ...)               # cells 21/23
    mask, det = model_inference.predict(ds_test)        # cells 21/25
    mask, det = model_inference(image_batch, training=False)  # cell 31

This module provides that surface on the port: the builders subclass
`ssdseglib_torch.models` builders, `get_model_for_training` returns a
`KerasStyleModel` whose `fit` runs the port's `Trainer` step with the
compiled loss and metric dicts as its objective, `save` writes a
TF-2.13-layout `.keras` zip with the model config embedded (the same
``ssdseglib_tpu.json`` member as the JAX facade writes, so files cross
between the two facades), and `get_model_for_inference` accepts the facade,
a loaded checkpoint, a ``state_dict`` or a live Keras model (weights
imported by name through `ssdseglib_torch.keras_import`).  Every builder and
`load_model` runs on the card unless the caller asks for the CPU
(``device=``).  TensorFlow is never imported here, and ``h5py`` only by a
`.keras` save or load.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
import zipfile
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ssdseglib_torch.models as _impl
from ssdseglib_torch import keras_import
from ssdseglib_torch.compat.datacoder import COLOR_AUG_SEED_KEY as _COLOR_AUG_SEED_KEY
from ssdseglib_torch.config import ModelConfig, TrainConfig
from ssdseglib_torch.models.builder import SsdSegModel, _BuilderBase, count_parameters
from ssdseglib_torch.ops import color as color_ops
from ssdseglib_torch.train import Trainer
from ssdseglib_torch.utils.serving import format_outputs

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)

#: test-harness knob: cap `fit(epochs=...)` so the reference notebook's
#: 105-epoch cell (notebook 03 cell 16) can execute as written in a bounded
#: budget.  Unset = no cap.  When it caps, fit prints a notice.
MAX_EPOCHS_ENV = "SSDSEGLIB_MAX_EPOCHS"

# the member that marks a `.keras` file written by either facade; its name
# is the file format's, shared with ssdseglib/models.py
_CONFIG_MEMBER = "ssdseglib_tpu.json"

# the reference's seed (notebook 03 cell 2): the facade's initial weights
_INIT_SEED = 1993


# -- config (de)serialization ------------------------------------------------

def _tuplify(value):
    if isinstance(value, list):
        return tuple(_tuplify(v) for v in value)
    return value


def _config_to_json(cfg: ModelConfig) -> str:
    return json.dumps(
        {"model_config": dataclasses.asdict(cfg), "format": "ssdseglib-tpu-v1"}
    )


def _config_from_json(text: str) -> ModelConfig:
    payload = json.loads(text)
    fields = {k: _tuplify(v) for k, v in payload["model_config"].items()}
    return ModelConfig(**fields)


# -- dataset iteration -------------------------------------------------------

def _is_tf_dataset(x) -> bool:
    return hasattr(x, "as_numpy_iterator") and hasattr(x, "element_spec")


def _iter_batches(data):
    """Yield numpy batches from a tf.data.Dataset or any (re-)iterable."""
    if _is_tf_dataset(data):
        return data.as_numpy_iterator()
    if callable(data) and not hasattr(data, "__iter__"):
        return iter(data())
    return iter(data)


def _learning_rate_of(optimizer) -> float:
    """Extract a float learning rate from a Keras optimizer (the notebooks
    pass `tf.keras.optimizers.Adam(learning_rate=1e-4)` -- notebook 03 cell
    14), a plain float, or None (Keras Adam default)."""
    if optimizer is None:
        return 1e-3
    if isinstance(optimizer, (int, float)):
        return float(optimizer)
    lr = getattr(optimizer, "learning_rate", None)
    if lr is None:
        return 1e-3
    try:
        return float(np.asarray(lr))
    except (TypeError, ValueError):
        return float(lr.numpy())


class History:
    """Minimal `keras.callbacks.History` stand-in (`.history`, `.epoch`)."""

    def __init__(self) -> None:
        self.history: Dict[str, list] = {}
        self.epoch: list = []


# -- the wire ------------------------------------------------------------------
#
# The facade consumes arbitrary host pipelines (the notebooks pass tf.data
# datasets -- reference notebook 03 cell 8), so Trainer.fit's transform on
# the card does not apply; the same levers are rebuilt for host batches:
#   1. exact uint8 packing: the largest upload is the one-hot f32 mask
#      target (B, 480, 640, C) = 78 MB at batch 16; exactly-one-hot targets
#      pack to a uint8 class map (16x smaller) and are one-hot again on the
#      device -- bit-exact, because the reference encoder emits {0,1}
#      one-hot (reference datacoder.py:247-248, :333)
#   2. a producer thread, so host decode / encode (tf.data numpy_function)
#      and packing overlap the device's work
#   3. chunked uploads through pinned memory, queued on the stream behind
#      the steps already dispatched (`_staged_batches`)

_TARGET_KEYS = ("output-mask", "output-labels", "output-boxes")


def _pack_one_hot(arr):
    """uint8 class map iff `arr` is an exact {0,1} float32 one-hot over
    its last axis, else None.

    Per-pixel `argmax(-1)`/`max(-1)`/`sum(-1)` over a tiny last axis are
    slow strided loops in NumPy.  Instead, ONE BLAS gemm computes three
    moments per row -- `s = sum(v)`, `q = sum(i*v)`, `r = sum(i^2*v)` -- and
    the certificate [all entries >= 0, s == 1, r == q*q] holds exactly iff
    the row is one-hot (nonneg weights with zero variance concentrate on the
    single index q).  For true one-hot rows every quantity is a
    small-integer float, so the f32 equalities are exact, and q IS the class
    index.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.float32 or arr.ndim < 2 or arr.size == 0:
        return None
    c = arr.shape[-1]
    if c < 2 or c > 255 or arr.min() < 0.0:
        return None
    flat = arr.reshape(-1, c)
    idx = np.arange(c, dtype=np.float32)
    moments = np.stack(
        [np.ones(c, np.float32), idx, idx * idx], axis=1
    )
    p = flat @ moments
    if not (p[:, 0] == 1.0).all():
        return None
    q = p[:, 1]
    if not (p[:, 2] == q * q).all():
        return None
    return q.astype(np.uint8).reshape(arr.shape[:-1])


def _pack_images_u8(images):
    """uint8 view iff every pixel is an exact uint8 value (integers in
    [0, 255] -- true for un-augmented pipelines; the reference's float
    color augmentation produces non-integer pixels and stays f32).
    Cuts the largest host-to-device transfer 4x; the step casts back to f32
    on the device, bit-exactly."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        return images
    if images.dtype != np.float32:
        return None
    u8 = images.astype(np.uint8)
    if (u8.astype(np.float32) == images).all():
        return u8
    return None


def _pack_host_batch(images, targets):
    """Pack one host batch for upload; returns (kind, flat_tuple).
    kind = (targets_packed, images_u8, color_aug) booleans selecting the
    matching unpack on the device (`make_unflatten`).

    Batches from the packed tf.data bridge (compat/datacoder.py) arrive
    PRE-packed -- uint8 class-map mask (B, H, W) / uint8 label indices
    (B, N) / uint8 images -- and skip the packing gemms entirely; a
    `COLOR_AUG_SEED_KEY` entry in the targets dict requests the deferred
    color jitter on the device (seed appended as a scalar int32 leaf)."""
    seed = targets.get(_COLOR_AUG_SEED_KEY) if isinstance(targets, dict) else None
    mask = np.asarray(targets["output-mask"])
    labels = np.asarray(targets["output-labels"])
    boxes = np.asarray(targets["output-boxes"], np.float32)
    # pre-packed class maps are uint8 AND rank-reduced -- (B, H, W) mask,
    # (B, N) labels; a uint8 ONE-HOT tensor (rank 4 / rank 3) must take
    # the certificate path below, not be misread as class indices
    if (mask.dtype == np.uint8 and labels.dtype == np.uint8
            and mask.ndim == 3 and labels.ndim == 2):
        mask_u8, labels_u8 = mask, labels
    else:
        mask_u8 = _pack_one_hot(mask)
        labels_u8 = _pack_one_hot(labels) if mask_u8 is not None else None
    images_u8 = _pack_images_u8(images)
    targets_packed = mask_u8 is not None and labels_u8 is not None
    kind = (targets_packed, images_u8 is not None, seed is not None)
    flat = (
        images_u8 if images_u8 is not None else np.asarray(images, np.float32),
        mask_u8 if targets_packed else mask,
        labels_u8 if targets_packed else labels,
        boxes,
    )
    if seed is not None:
        flat = flat + (np.asarray(seed, np.int32),)
    return kind, flat


def _one_hot(class_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot over a new last axis; a value outside [0, num_classes)
    gives an all-zero row, as ``tf.one_hot`` and ``jax.nn.one_hot`` do."""
    classes = torch.arange(num_classes, dtype=class_map.dtype, device=class_map.device)
    return (class_map.unsqueeze(-1) == classes).float()


def make_unflatten(kind, num_classes: int):
    """Unpack for one flat batch on its device, by `kind` = (targets_packed,
    images_u8, color_aug): uint8 -> f32 image cast, the deferred per-batch
    color jitter from the seed leaf (`ops/color.py`, reference
    datacoder.py:434-466 semantics; a ``torch.Generator`` on the batch's
    device seeded from the leaf), and bit-exact one-hot reconstruction of
    packed class maps.  Module-level so the unpack semantics are testable
    outside a train step.  Arrays or tensors in, tensors out."""
    targets_packed, images_u8, color_aug = kind

    def unflatten(images, mask, labels, boxes, *rest):
        images, mask, labels, boxes = (
            torch.as_tensor(a) for a in (images, mask, labels, boxes)
        )
        if images_u8:
            images = images.float()
        if color_aug:
            generator = torch.Generator(device=images.device).manual_seed(int(rest[0]))
            images = color_ops.augmentation_rgb_channels(generator, images)
        if targets_packed:
            mask = _one_hot(mask, num_classes)
            labels = _one_hot(labels, num_classes)
        return images, {
            "output-mask": mask,
            "output-labels": labels,
            "output-boxes": boxes,
        }

    return unflatten


# -- staging -------------------------------------------------------------------

class _DeviceBatchCache:
    """Device-resident memo of packed + uploaded batches, keyed by the
    IDENTITY of the host arrays.

    Re-iterating the same in-memory batch objects epoch after epoch (a
    list of numpy batches, a cached dataset) re-pays host packing and the
    whole host-to-device copy every epoch.  The cache keeps the uploaded
    device tensors alive across epochs, so a resident dataset trains from
    device memory.

    Safety: entries are keyed by `id()` of the four host arrays AND hold
    weakrefs to them -- an entry dies with its host array, so a recycled
    id can never alias a dead object.  Fresh-arrays-per-epoch pipelines
    (tf.data) simply miss and their entries evaporate with the arrays.
    The one hazard is an array MUTATED IN PLACE between epochs (same
    object, new contents): pass ``fit(..., cache_batches=False)`` for
    such pipelines.  LRU-bounded by device bytes
    (SSDSEGLIB_BATCH_CACHE_MB, default 2048).

    key_mode='content' instead keys by a blake2b digest of the array
    BYTES (`fit(..., cache_batches='content')`): fresh-but-identical
    arrays per epoch (a deterministic un-augmented tf.data pipeline,
    whose `as_numpy_iterator` materializes new buffers every pass) then
    HIT, at about the cost of one memory pass per miss epoch.  Pipelines
    with live augmentation (the reference notebook's -- random flip +
    color jitter per epoch, reference notebook 03 cell 3) can never hit
    under EITHER mode; their lever is the packed wire format.
    """

    def __init__(
        self, max_bytes: Optional[int] = None, key_mode: str = "id"
    ) -> None:
        import threading

        self._lock = threading.RLock()
        self._entries: Dict[Any, Any] = {}
        self._order: Dict[Any, None] = {}  # insertion-ordered LRU
        self._bytes = 0
        self.key_mode = key_mode
        self._max = max_bytes if max_bytes is not None else (
            int(os.environ.get("SSDSEGLIB_BATCH_CACHE_MB", "2048")) << 20
        )

    def key_refs(self, images, targets):
        import weakref

        objs = (
            images,
            targets["output-mask"],
            targets["output-labels"],
            targets["output-boxes"],
        )
        seed = (
            targets.get(_COLOR_AUG_SEED_KEY)
            if isinstance(targets, dict)
            else None
        )
        if seed is not None:
            # a live per-batch jitter seed exists precisely so the batch
            # DIFFERS every epoch: such batches are never cacheable.
            # Keying them would only pin dead device entries (content
            # keys are unique forever) and pay a pointless hash pass.
            return None, None

        if self.key_mode == "content":
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            for o in objs:
                arr = np.ascontiguousarray(np.asarray(o))
                h.update(str((arr.dtype.str, arr.shape)).encode())
                h.update(memoryview(arr).cast("B"))
            return ("content", h.hexdigest()), None

        key = tuple(id(o) for o in objs)

        def evict(_ref, key=key):
            with self._lock:
                entry = self._entries.pop(key, None)
                self._order.pop(key, None)
                if entry is not None:
                    self._bytes -= entry[3]

        try:
            refs = tuple(weakref.ref(o, evict) for o in objs)
        except TypeError:
            return None, None  # unweakrefable host type: no caching
        return key, refs

    def get(self, key):
        if key is None:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._order.pop(key, None)
            self._order[key] = None
            return entry[1], entry[2]  # (kind, device_batch)

    def insert(self, key, refs, kind, device_batch) -> None:
        if key is None:
            return
        nbytes = sum(int(getattr(a, "nbytes", 0)) for a in device_batch)
        with self._lock:
            if key in self._entries:
                return
            while self._bytes + nbytes > self._max and self._order:
                old = next(iter(self._order))
                self._order.pop(old)
                entry = self._entries.pop(old, None)
                if entry is not None:
                    self._bytes -= entry[3]
            if self._bytes + nbytes > self._max:
                return  # single batch larger than the whole budget
            self._entries[key] = (refs, kind, device_batch, nbytes)
            self._order[key] = None
            self._bytes += nbytes


class _Prefetcher:
    """Producer thread: pulls host batches ahead of the dispatch loop,
    resolving each against the device cache (hits skip packing entirely)
    and packing misses.  Exceptions propagate; `close()` stops early."""

    _DONE = object()

    def __init__(self, batches, cache=None, depth: int = 4) -> None:
        import queue
        import threading

        self._q: Any = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def produce():
            try:
                for images, targets in batches:
                    if self._stop.is_set():
                        break
                    key = refs = None
                    if cache is not None:
                        key, refs = cache.key_refs(images, targets)
                        hit = cache.get(key)
                        if hit is not None:
                            item = ("hit", hit[0], hit[1])
                        else:
                            kind, flat = _pack_host_batch(images, targets)
                            item = ("miss", key, refs, kind, flat)
                    else:
                        kind, flat = _pack_host_batch(images, targets)
                        item = ("miss", None, None, kind, flat)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as exc:  # relayed to the consumer, which raises it
                self._q.put(exc)
            else:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()


def _staged_batches(data, device: torch.device, cache=None, chunk_size: int = 2):
    """Yield (kind, device_batch) with prefetch, device-cache reuse and
    chunked uploads.

    Each chunk's arrays go through pinned host memory with non-blocking
    copies (`data.pipeline.upload_batch`), queued on the current stream
    behind the steps already dispatched, as `Trainer._staged` does: the
    stream's order is the fence, and the host waits for nothing (the JAX
    facade blocks on the last metric before each chunk, because a transfer
    issued behind queued compute serializes on a remote-attached TPU).  A
    jitter seed stays on the host, where its generator is seeded.  Cache
    hits need no upload and dispatch at once.  chunk_size 2 keeps the
    producer packing batch N+2 while batch N uploads and N+1 computes.
    """
    from ssdseglib_torch.data.pipeline import upload_batch

    prefetcher = _Prefetcher(_zip_batches(data), cache)
    try:
        buf = []

        def flush():
            for key, refs, kind, flat in buf:
                dev = upload_batch(flat[:4], device) + tuple(int(s) for s in flat[4:])
                if cache is not None:
                    cache.insert(key, refs, kind, dev)
                yield (kind, dev)
            buf.clear()

        for item in prefetcher:
            if item[0] == "hit":
                yield from flush()  # preserve batch order
                yield (item[1], item[2])
            else:
                buf.append(item[1:])
                if len(buf) >= chunk_size:
                    yield from flush()
        yield from flush()
    finally:
        prefetcher.close()


def _zip_batches(data):
    for batch in _iter_batches(data):
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            yield batch[0], batch[1]
        else:
            raise ValueError(
                "fit/evaluate expect (images, targets-dict) batches"
            )


# -- the model -----------------------------------------------------------------

@dataclasses.dataclass
class _CompiledTrainer(Trainer):
    """The port's `Trainer` (its step: mixed precision, backward gates,
    Adam) with the compiled loss and metric dicts as its objective:
    ``objective(outputs, targets) -> (total, logs)``."""

    objective: Optional[Callable] = None

    def _losses_and_metrics(self, outputs, targets):
        return self.objective(outputs, targets)


def _objective(losses, weights, metric_fns) -> Callable:
    """Keras's compiled objective: each output's per-sample loss is
    batch-averaged and combined with `loss_weights` (total = sum_i w_i *
    mean_i); logs ``{name}_loss``, ``loss`` and ``{name}_{metric name}``,
    detached."""

    def losses_and_logs(outputs, targets):
        logs = {}
        total = None
        for name, fn in losses.items():
            value = fn(targets[name], outputs[name]).mean()
            term = float(weights.get(name, 1.0)) * value
            total = term if total is None else total + term
            logs[f"{name}_loss"] = value
        logs["loss"] = total
        with torch.no_grad():
            for name, fn in metric_fns.items():
                label = getattr(fn, "__name__", "metric")
                logs[f"{name}_{label}"] = fn(targets[name], outputs[name]).mean()
        return total, {k: v.detach() for k, v in logs.items()}

    return losses_and_logs


class KerasStyleModel:
    """compile/fit/predict/save facade over the port's `SsdSegModel` and
    `Trainer` step.

    One train step per batch (forward in train mode, the compiled losses and
    metrics, backward, Adam, BatchNorm statistics, on the model's device);
    metrics add up on the device and the host reads them once an epoch.
    """

    def __init__(self, module: SsdSegModel, name: str = "ssdseg") -> None:
        self.module = module
        self.cfg = module.cfg
        self.name = name
        self.device = next(module.parameters()).device
        self._compiled: Optional[Dict[str, Any]] = None
        self._trainer: Optional[_CompiledTrainer] = None
        self._state = None  # TrainState, persists across fit calls
        self._cache = None  # _DeviceBatchCache, persists across fit calls

    def _batch_cache(self, cache_batches) -> "Optional[_DeviceBatchCache]":
        """Resolve the `cache_batches` knob: False -> no cache, True ->
        identity keys, 'content' -> content keys (see `_DeviceBatchCache`).
        SSDSEGLIB_BATCH_CACHE_KEY=content upgrades True to content mode.
        The cache persists across fit/evaluate calls; switching modes
        rebuilds it."""
        if not cache_batches:
            return None
        mode = (
            cache_batches
            if isinstance(cache_batches, str)
            else os.environ.get("SSDSEGLIB_BATCH_CACHE_KEY", "id")
        )
        if mode not in ("id", "content"):
            raise ValueError(
                f"cache_batches mode must be 'id' or 'content', got {mode!r}"
            )
        if self._cache is None or self._cache.key_mode != mode:
            self._cache = _DeviceBatchCache(key_mode=mode)
        return self._cache

    # -- variables -------------------------------------------------------
    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` (parameters and BatchNorm statistics)
        on its device: at first the draw of a ``torch.Generator`` seeded
        with the reference seed 1993 (notebook 03 cell 2), made when the
        builder made the model; after `fit`, the trained values."""
        return self.module.state_dict()

    def set_variables(self, variables) -> None:
        """Load a ``state_dict`` of this configuration (any float dtype, any
        device; BatchNorm's ``num_batches_tracked`` may be absent)."""
        missing, unexpected = self.module.load_state_dict(dict(variables), strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(
                f"variables do not fit the model: missing {missing[:5]}, "
                f"unexpected {unexpected[:5]}"
            )
        self._state = None  # stale optimizer state refers to old params

    # -- keras-surface ---------------------------------------------------
    def summary(self, print_fn: Callable[[str], None] = print) -> None:
        trainable, stats = count_parameters(self.module)
        print_fn(f'Model: "{self.name}"')
        shape = (None,) + tuple(self.cfg.input_image_shape)
        print_fn(f"  input: {shape}")
        n = sum(
            h * w * b
            for (h, w), b in zip(
                self._head_feature_shapes(), self.cfg.boxes_per_point
            )
        )
        # labels get 4 channels and boxes get number_of_classes -- the
        # reference's preserved head channel-swap quirk (reference
        # models.py:250-268; equal only because num_classes == 4 in the
        # published config)
        print_fn(
            f"  outputs: output-mask (None, {shape[1]}, {shape[2]}, "
            f"{self.cfg.number_of_classes}), output-labels (None, {n}, 4), "
            f"output-boxes (None, {n}, {self.cfg.number_of_classes})"
        )
        print_fn("=" * 65)
        print_fn(f"Total params: {trainable + stats:,}")
        print_fn(f"Trainable params: {trainable:,}")
        print_fn(f"Non-trainable params: {stats:,}")

    def _head_feature_shapes(self):
        # detection pyramid: os16 tap, os32 tap, then two stride-2 SAME
        # blocks (out = ceil(in / 2)) -- reference models.py:229-244
        def ceil2(a):
            return -(-a // 2)

        h, w = self.cfg.input_image_shape[:2]
        fm1 = (h // 16, w // 16)
        fm2 = (h // 32, w // 32)
        fm3 = (ceil2(fm2[0]), ceil2(fm2[1]))
        fm4 = (ceil2(fm3[0]), ceil2(fm3[1]))
        return [fm1, fm2, fm3, fm4]

    def count_params(self) -> int:
        trainable, stats = count_parameters(self.module)
        return trainable + stats

    def compile(
        self,
        optimizer=None,
        loss: Optional[Dict[str, Callable]] = None,
        loss_weights: Optional[Dict[str, float]] = None,
        metrics: Optional[Dict[str, Callable]] = None,
        compute_dtype: Optional[str] = None,
        **_ignored,
    ) -> None:
        """Record the training objective (reference notebook 03 cell 14).

        `loss` / `metrics` values are `(y_true, y_pred) -> (B,)` callables --
        the `compat.losses` / `compat.metrics` factories are the port's
        torch functions, so they run inside the step directly.  The
        optimizer is Adam (``optax.adam``'s defaults) at the learning rate of
        `optimizer`: a float, an object with ``learning_rate``, or None.

        compute_dtype: forward/backward compute precision ('float32'
        default = reference parity; 'bfloat16' = the port Trainer's mixed
        precision -- f32 master params, f32 losses and BatchNorm statistics).
        Also settable via the SSDSEGLIB_COMPUTE_DTYPE env var; the explicit
        argument wins.
        """
        if not loss:
            raise ValueError("compile() needs a loss dict keyed by output name")
        dtype = compute_dtype or os.environ.get(
            "SSDSEGLIB_COMPUTE_DTYPE", "float32"
        )
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {dtype!r}"
            )
        self._compiled = {
            "loss": dict(loss),
            "loss_weights": dict(loss_weights or {}),
            "metrics": dict(metrics or {}),
            "learning_rate": _learning_rate_of(optimizer),
            "compute_dtype": dtype,
        }
        self._trainer = None
        self._state = None

    # -- steps -----------------------------------------------------------
    def _ensure_trainer(self) -> _CompiledTrainer:
        if self._compiled is None:
            raise RuntimeError("call compile(...) before fit/evaluate")
        if self._trainer is None:
            compiled = self._compiled
            self._trainer = _CompiledTrainer(
                model=self.module, anchors=None,
                config=TrainConfig(learning_rate=compiled["learning_rate"],
                                   compute_dtype=compiled["compute_dtype"],
                                   streaming_metrics="loss_only"),
                device=self.device,
                objective=_objective(compiled["loss"], compiled["loss_weights"],
                                     compiled["metrics"]),
            )
        return self._trainer

    def _ensure_state(self):
        if self._state is None:
            self._state = self._ensure_trainer().init_state(variables=self.variables)
        return self._state

    def _train_step(self, kind, batch) -> Dict[str, torch.Tensor]:
        """One step on an uploaded flat batch: (targets_packed, images_u8,
        color_aug) unpack, then the trainer's step on the state in place."""
        images, targets = make_unflatten(kind, self.cfg.number_of_classes)(*batch)
        return self._trainer.train_step(self._state, images, targets)[1]

    def _eval_step(self, kind, batch) -> Dict[str, torch.Tensor]:
        images, targets = make_unflatten(kind, self.cfg.number_of_classes)(*batch)
        return self._trainer.eval_step(self._state, images, targets)

    def _run(self, data, step, cache, limit=None):
        """(sums of the logs on the device, number of batches) of one pass
        of ``step`` over ``data``."""
        agg: Dict[str, torch.Tensor] = {}
        n = 0
        for kind, batch in _staged_batches(data, self.device, cache):
            logs = step(kind, batch)
            n += 1
            for k, v in logs.items():
                agg[k] = v if k not in agg else agg[k] + v
            if limit and n >= limit:
                break
        return agg, n

    # -- training loop ---------------------------------------------------
    def fit(
        self,
        x=None,
        epochs: int = 1,
        verbose="auto",
        validation_data=None,
        callbacks=None,
        steps_per_epoch: Optional[int] = None,
        cache_batches: bool = True,
        **_ignored,
    ) -> History:
        """Keras-style epoch loop (reference notebook 03 cell 16).

        `x` / `validation_data`: a tf.data.Dataset yielding
        ``(images, {'output-mask', 'output-labels', 'output-boxes'})``
        batches (the notebook pipeline), or any re-iterable of such pairs.

        cache_batches: keep uploaded batches device-resident across
        epochs -- True keys by host-array identity, 'content' by array
        bytes (hits fresh-but-identical arrays, e.g. a deterministic
        un-augmented tf.data pipeline re-materializing per epoch; see
        `_DeviceBatchCache`), False disables (required for pipelines that
        MUTATE batch arrays in place under identity keys).
        """
        cap = os.environ.get(MAX_EPOCHS_ENV)
        if cap is not None and epochs > int(cap):
            print(
                f"[ssdseglib compat] {MAX_EPOCHS_ENV}={cap} caps "
                f"fit(epochs={epochs}) for the test harness"
            )
            epochs = int(cap)

        self._ensure_state()
        history = History()
        cache = self._batch_cache(cache_batches)

        for epoch in range(epochs):
            t0 = time.perf_counter()
            # accumulate metrics ON DEVICE; float() once per epoch
            agg, n = self._run(x, self._train_step, cache, steps_per_epoch)
            for k in agg:
                history.history.setdefault(k, []).append(
                    float(agg[k]) / max(n, 1)
                )

            if validation_data is not None:
                vagg, vn = self._run(validation_data, self._eval_step, cache)
                for k in vagg:
                    history.history.setdefault(f"val_{k}", []).append(
                        float(vagg[k]) / max(vn, 1)
                    )

            history.epoch.append(epoch)
            # SSDSEGLIB_VERBOSE_FIT=1: runner-controlled progress lines even
            # when the cell passes verbose=0 (reference notebook 03 cell 16)
            if os.environ.get("SSDSEGLIB_VERBOSE_FIT") == "1" or verbose not in (
                0,
                "0",
            ):
                dt = time.perf_counter() - t0
                line = f"epoch {epoch + 1}/{epochs} [{dt:.1f}s, {n} steps]"
                for k in ("loss", "val_loss"):
                    if k in history.history:
                        line += f" {k}={history.history[k][-1]:.4f}"
                print(line)

        # the trained values become the model's
        self.module.load_state_dict(self._state.variables(), strict=False)
        return history

    def evaluate(self, x=None, verbose="auto", return_dict: bool = True,
                 cache_batches: bool = True, **_):
        self._ensure_state()
        agg, n = self._run(x, self._eval_step, self._batch_cache(cache_batches))
        out = {k: float(v) / max(n, 1) for k, v in agg.items()}
        return out if return_dict else [out.get("loss", 0.0)]

    @torch.no_grad()
    def _outputs(self, images):
        """The eval-mode network's raw outputs of one batch in f32, as
        NumPy, in the reference's order [mask, labels, boxes]."""
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        self.module.eval()
        out = self.module(x)
        return [out[k].float().cpu().numpy() for k in _TARGET_KEYS]

    def predict(self, x, verbose="auto", **_):
        """Raw training-graph outputs as [mask, labels, boxes] (the
        reference model's output order, reference models.py:338)."""
        outs = {k: [] for k in _TARGET_KEYS}
        for batch in _iter_batches(x):
            images = batch[0] if isinstance(batch, (tuple, list)) else batch
            for k, value in zip(_TARGET_KEYS, self._outputs(images)):
                outs[k].append(value)
        return [np.concatenate(outs[k], axis=0) for k in _TARGET_KEYS]

    def __call__(self, images, training: bool = False):
        return self._outputs(images)

    # -- persistence -----------------------------------------------------
    def save(self, filepath) -> None:
        """Save weights (+ config) -- `.keras` writes the TF-2.13 zip layout
        (reference notebook 03 cell 17; needs h5py), anything else a flat
        `.npz` under the JAX package's names (`checkpoint.save_params_npz`)."""
        filepath = str(filepath)
        parent = os.path.dirname(filepath)
        if parent:
            os.makedirs(parent, exist_ok=True)
        variables = self.variables
        if filepath.endswith(".keras"):
            keras_import.save_keras_file(
                filepath,
                keras_import.export_keras_weights(variables, self.cfg),
                extra_files={_CONFIG_MEMBER: _config_to_json(self.cfg)},
            )
        else:
            from ssdseglib_torch.checkpoint import save_params_npz

            save_params_npz(filepath, variables)


class CompatInferenceModel:
    """Reference inference-model surface over `InferenceModel`
    (reference models.py:345-423 and notebook 03 cells 21/25/31):
    callable with `training=`, `predict` over a tf.data.Dataset."""

    def __init__(self, inner, suppress_background_boxes: bool) -> None:
        self._inner = inner
        self._suppress_background = suppress_background_boxes

    def __call__(self, images, training: bool = False):
        # reference behavior: the NMS layer removes background rows INSIDE
        # its call, flattening the batch structure (reference
        # layers.py:165-166) -- direct calls match predict()
        return format_outputs(*self._inner(np.asarray(images, np.float32)),
                              self._suppress_background)

    def predict(self, x, verbose="auto", **_):
        """Predict over a dataset/array; returns ``(mask_batch,
        detection_batch)`` stacked across all batches like Keras
        `Model.predict` (reference notebook 03 cell 25)."""
        masks, dets = [], []
        if isinstance(x, np.ndarray) or (
            hasattr(x, "shape") and not _is_tf_dataset(x)
        ):
            batches = [np.asarray(x)]
        else:
            batches = _iter_batches(x)
        for batch in batches:
            images = batch[0] if isinstance(batch, (tuple, list)) else batch
            mask, det = self(images)
            masks.append(mask)
            dets.append(det)
        mask = np.concatenate(masks, axis=0)
        det = np.concatenate(dets, axis=0)
        if self._suppress_background:
            # reference behavior: background-row removal drops the batch
            # structure (reference layers.py:165-166)
            det = det[det[..., 0] > 0.0]
        return mask, det

    def raw_outputs(self, images):
        return self._inner.raw_outputs(images)


def _resolve_variables(model_trained, builder) -> Any:
    """Accept the facade, a loaded checkpoint object, a genuine Keras
    model, or a ``state_dict``; return what the port's builder serves: the
    facade's network itself (its configuration with it), or a
    ``state_dict``."""
    if isinstance(model_trained, KerasStyleModel):
        return model_trained.module
    if hasattr(model_trained, "layers") and hasattr(
        model_trained, "get_weights"
    ):
        # a live (TF) Keras model: import weights by layer name
        cfg = builder._model_cfg
        if cfg is None:
            # build the default config the reference ctor surface implies
            _BuilderBase.get_model_for_training(builder, device="cpu")
            cfg = builder._model_cfg
        return keras_import.import_keras_weights(
            keras_import.weights_by_layer_from_keras_model(model_trained), cfg
        )
    return model_trained


class _CompatBuilderMixin:
    """Builder overrides returning the Keras-style facade objects; both take
    ``device=`` (the card unless the caller asks for the CPU) and pass it
    to the port's builder."""

    _facade_name = "ssdseg"

    def get_model_for_training(self, *args, generator: Optional[torch.Generator] = None,
                               device="cuda", **kwargs) -> KerasStyleModel:
        if generator is None:
            generator = torch.Generator().manual_seed(_INIT_SEED)
        module = super().get_model_for_training(*args, generator=generator, device=device,
                                                **kwargs)
        return KerasStyleModel(module, name=self._facade_name)

    def get_model_for_inference(self, model_trained, *args, device="cuda", **kwargs):
        """Every keyword of the port's `get_model_for_inference` passes
        through (``compute_dtype``, ``fused_backbone``, ``mask_output``,
        ``mesh``)."""
        variables = _resolve_variables(model_trained, self)
        inner = super().get_model_for_inference(variables, *args, device=device, **kwargs)
        suppress = kwargs.get("suppress_background_boxes")
        if suppress is None and len(args) >= 5:
            suppress = args[4]
        return CompatInferenceModel(
            inner, suppress_background_boxes=bool(suppress)
        )


class MobileNetV2SsdSegBuilder(
    _CompatBuilderMixin, _impl.MobileNetV2SsdSegBuilder
):
    """Reference `MobileNetV2SsdSegBuilder` (reference models.py:6-45) with
    Keras-style return objects."""

    _facade_name = "mobilenetv2-deeplabv3plus-ssdlite"


class ShuffleNetV2SsdSegBuilder(
    _CompatBuilderMixin, _impl.ShuffleNetV2SsdSegBuilder
):
    """Reference `ShuffleNetV2SsdSegBuilder` (reference models.py:425-478)
    with Keras-style return objects."""

    _facade_name = "shufflenetv2-deeplabv3plus-ssdlite"


# -- load path ---------------------------------------------------------------

def is_ssdseglib_tpu_file(filepath) -> bool:
    """True if `filepath` is a `.keras` zip written by either facade (the
    name is the file format's)."""
    try:
        with zipfile.ZipFile(str(filepath)) as zf:
            return _CONFIG_MEMBER in zf.namelist()
    except (OSError, zipfile.BadZipFile, IsADirectoryError):
        return False


def load_model(filepath, compile: bool = False, device="cuda",
               **_ignored) -> KerasStyleModel:
    """Load a `.keras` checkpoint written by either facade's
    `KerasStyleModel.save` back into this facade, on ``device`` (the card
    unless the caller asks for the CPU; reference notebook 03 cell 19
    recipe).  Needs h5py."""
    filepath = str(filepath)
    with zipfile.ZipFile(filepath) as zf:
        cfg = _config_from_json(zf.read(_CONFIG_MEMBER).decode())
    variables = keras_import.import_keras_weights(
        keras_import.load_keras_file(filepath), cfg
    )
    module = SsdSegModel(cfg, torch.Generator().manual_seed(_INIT_SEED)).to(device)
    model = KerasStyleModel(module, name=os.path.basename(filepath))
    model.set_variables(variables)
    return model


def install_tf_load_model_shim() -> None:
    """Wrap `tf.keras.models.load_model` so `.keras` files written by either
    facade load back as this facade's `KerasStyleModel` (reference notebook
    03 cell 19 calls the TF loader directly).  Foreign files pass through
    untouched.  Only installs if TensorFlow is already imported; idempotent.

    One facade's shim a process: the JAX facade (``ssdseglib``) installs its
    own the same way, and whichever is installed first stays (each leaves an
    installed shim alone), so a process that imports both facades loads
    these files into the first one's model."""
    tf = sys.modules.get("tensorflow")
    if tf is None:
        return
    try:
        original = tf.keras.models.load_model
    except AttributeError:
        return
    if getattr(original, "_ssdseglib_shim", False):
        return

    @functools.wraps(original)
    def load_model_shim(filepath, *args, **kwargs):
        if is_ssdseglib_tpu_file(filepath):
            return load_model(filepath, compile=kwargs.get("compile", False),
                              device=kwargs.get("device", "cuda"))
        return original(filepath, *args, **kwargs)

    load_model_shim._ssdseglib_shim = True
    tf.keras.models.load_model = load_model_shim


del _impl
