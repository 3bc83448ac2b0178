"""Input pipeline: host decode/pad + threaded prefetch + device transform
(PyTorch), counterpart of ssdseglib_tpu/data/pipeline.py.

Replaces the reference's tf.data pipeline (reference notebook 03 cell 8:
from_tensor_slices -> shuffle -> map(read_and_encode) -> batch ->
map(augmentation) -> prefetch).  The host only decodes PNGs/CSVs into
fixed-shape uint8/padded arrays; everything compute-shaped — flip, color
jitter, one-hot, anchor matching — runs batched on the device.

Pipeline stages:
  host threads: decode PNG/CSV -> pad -> assemble numpy batch
  prefetch queue (double-buffered)
  pinned, non-blocking upload
  device: `make_train_batch_transform` (datacoder.py)

On-disk datasets decode in the native C++ batch assembler
(``data/native_loader.py``) by default, as in the JAX package, with its
per-batch fallback to the PIL path.

Under data parallelism (``TrainDataLoader(..., mesh=)``) every rank walks the
same global batch order (same seed) and decodes only its slice; the
augmentation draws are made for the global batch and sliced, so the ranks
together see what one process sees.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import EncodingConfig
from ssdseglib_torch.data.synthetic import SyntheticSample
from ssdseglib_torch.datacoder import (
    decoded_cache_key,
    make_train_batch_transform,
    pad_ground_truth,
    read_sample,
)
from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.utils import sample_cache as _sample_cache
from ssdseglib_torch.utils.profiling import span

PathTriple = Tuple[str, str, str]  # (image.png, mask.png, labels_boxes.csv)
Sample = Union[PathTriple, SyntheticSample]


class _ProducerError:
    """Queue marker carrying a producer-thread exception to the consumer
    (a raw raise would die with the daemon thread and hang `q.get()`)."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


def load_dataset_json(path: str, root: Optional[str] = None) -> List[PathTriple]:
    """Load a reference-format dataset JSON: a list of
    [image.png, mask.png, labels_boxes.csv] triples (reference data/*.json).

    The reference stores paths relative to the REPO root, not to the JSON
    file (e.g. `data/train/1.png` inside `data/train.json` — reference
    notebook 03 cell 4 opens them with cwd at the repo root).  With no
    explicit `root`, paths resolve against the JSON's directory; if EVERY
    triple instead starts with the JSON directory's own name AND the
    JSON-dir-relative resolution of the first file does not exist, the
    reference layout is assumed and paths resolve against the JSON's
    parent directory.
    """
    triples = json.load(open(path))
    if root is None:
        json_dir = os.path.dirname(os.path.abspath(path))
        dir_name = os.path.basename(json_dir)
        root = json_dir
        if triples and all(
            p.startswith(dir_name + "/") for t in triples for p in t
        ):
            # ambiguous: 'train/0.png' inside train.json could be either
            # layout — prefer whichever resolution actually exists
            if not os.path.exists(os.path.join(json_dir, triples[0][0])):
                root = os.path.dirname(json_dir)  # reference layout
    return [tuple(os.path.join(root, p) for p in t) for t in triples]


def _load_sample(sample: Sample, max_gt: int):
    """Host decode of one sample into fixed-shape arrays."""
    if isinstance(sample, SyntheticSample):
        return (sample.image, sample.mask) + pad_ground_truth(
            sample.labels, sample.boxes, max_gt)
    return read_sample(*sample, max_gt)


class HostBatcher:
    """Shuffling, threaded host loader producing numpy batches.

    Yields (images (B,H,W,3) u8, masks (B,H,W) u8, gt_labels (B,G),
    gt_boxes (B,G,4), gt_valid (B,G)).  Drops the trailing partial batch, as
    the JAX package does (its steps want static shapes); with
    ``drop_remainder=False`` it yields it, as the reference's ``tf.data``
    ``batch`` does.  ``shard = (index, count)``: of each batch of
    ``batch_size``, only the contiguous slice ``index`` of ``count`` equal
    slices is decoded and yielded (a batch that does not divide raises
    ValueError, as `parallel.shard_batch` does).

    While a profiler records, the producer thread's assembly of each batch
    is the span ``loader.batch`` and each wait of the consumer on the queue
    ``loader.wait``, whose value is the batches queued when the wait began;
    both are indexed by the batch's place in the epoch
    (`utils.profiling.span`).
    """

    def __init__(
        self,
        samples: Sequence[Sample],
        batch_size: int,
        max_ground_truth_boxes: int = 32,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        use_native: bool = True,
        image_shape: Optional[Tuple[int, int]] = None,
        use_sample_cache: bool = True,
        drop_remainder: bool = True,
        shard: Tuple[int, int] = (0, 1),
    ) -> None:
        """use_native: decode (image.png, mask.png, labels.csv) triples in
        the native C++ batch assembler (``data/native_loader.py``, built at
        first use; needs ``image_shape``).  A batch it cannot decode (a PNG
        outside its subset: 16-bit, interlaced, ...) falls back to the PIL
        path, with one warning; a loader that does not build warns once and
        every batch takes the PIL path."""
        self.samples = list(samples)
        self.batch_size = batch_size
        self.max_gt = max_ground_truth_boxes
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.shard = shard
        self._rng = np.random.default_rng(seed)

        all_paths = all(
            not isinstance(s, SyntheticSample) for s in self.samples
        )
        # cross-epoch decoded-sample memo (utils/sample_cache.py): decode
        # is deterministic per file, so epoch >= 2 assembles batches from
        # host RAM instead of re-inflating PNGs — the augmentation
        # randomness lives downstream in the device transform.
        # Shared process-wide.
        self._cache = (
            _sample_cache.global_sample_cache()
            if use_sample_cache and all_paths
            else None
        )
        if self._cache is not None and not self._cache.enabled:
            self._cache = None
        self._native = None
        self._native_fallback_warned = False
        if use_native and all_paths and self.samples and image_shape:
            from ssdseglib_torch.data import native_loader

            try:
                self._native = native_loader.NativeBatchLoader(
                    image_shape, max_ground_truth_boxes=max_ground_truth_boxes,
                    num_workers=num_workers)
            except native_loader.NativeLoaderError as e:
                warnings.warn(f"native loader unavailable ({e}); HostBatcher decodes "
                              "with PIL")

    def _decode_native(self, samples):
        """The batch from the native assembler, or None where it cannot
        decode it (the PIL path then takes it)."""
        from ssdseglib_torch.data.native_loader import NativeLoaderError

        try:
            return self._native.load_batch(samples)
        except NativeLoaderError as e:
            # the native decoder covers the dataset's PNG subset; PIL
            # decodes more (16-bit, interlaced, ...).  A pure IO failure
            # (missing or unreadable file) is no format limit: no warning,
            # and the PIL path raises the precise error for the bad path.
            if not e.is_io_error and not self._native_fallback_warned:
                warnings.warn(f"native loader failed ({e}); falling back to the PIL "
                              "path for affected batches")
                self._native_fallback_warned = True
            return None

    def __len__(self) -> int:
        if self.drop_remainder:
            return len(self.samples) // self.batch_size
        return -(-len(self.samples) // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            self._rng.shuffle(order)
        if not self.drop_remainder:
            batches = [order[i:i + self.batch_size]
                       for i in range(0, len(order), self.batch_size)]
        else:
            n_batches = len(order) // self.batch_size
            batches = np.split(order[: n_batches * self.batch_size], max(n_batches, 1))
        index, count = self.shard
        if count == 1:
            return batches
        for batch in batches:
            if batch.size % count:
                raise ValueError(
                    f"batch axis of shape ({batch.size},) is not divisible by the "
                    f"{count}-device mesh 'data' axis; pad the batch or use a "
                    f"divisible batch size"
                )
        return [b[index * (b.size // count):(index + 1) * (b.size // count)] for b in batches]

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        if not batches or batches[0].size == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that re-checks `stop`: an abandoned consumer
            (early `break` out of the epoch) must not leave the producer
            blocked forever on a full queue, pinning the thread plus a
            decoded batch."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:

                    def decode_stacked(samples):
                        if self._native is not None:
                            batch = self._decode_native(samples)
                            if batch is not None:
                                return batch
                        loaded = list(
                            pool.map(
                                lambda s: _load_sample(s, self.max_gt),
                                samples,
                            )
                        )
                        return tuple(
                            np.stack([s[j] for s in loaded]) for j in range(5)
                        )

                    def cached_batch(idx):
                        cache = self._cache
                        samples = [self.samples[i] for i in idx]
                        if cache is None:
                            return decode_stacked(samples)
                        keys, vals = [], []
                        for s in samples:
                            key = decoded_cache_key(self.max_gt, cache.stat_key(*s))
                            keys.append(key)
                            vals.append(cache.get(key) if key else None)
                        missing = [
                            j for j, v in enumerate(vals) if v is None
                        ]
                        if missing:
                            sub = decode_stacked([samples[j] for j in missing])
                            for row, j in enumerate(missing):
                                value = tuple(a[row].copy() for a in sub)
                                vals[j] = value
                                cache.put(keys[j], value)
                        return tuple(
                            np.stack([v[k] for v in vals]) for k in range(5)
                        )

                    for i, idx in enumerate(batches):
                        if stop.is_set():
                            return
                        with span("loader.batch", i):
                            batch = cached_batch(idx)
                        if not put(batch):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                put(_ProducerError(e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            for i in itertools.count():
                with span("loader.wait", i, q.qsize()):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()


def upload_batch(batch, device: torch.device):
    """The arrays of one raw host batch as tensors on ``device``.  For a
    CUDA device each goes through a pinned staging tensor and a non-blocking
    copy, so the host never waits for the transfer."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
    if device.type != "cuda":
        return tuple(t.to(device) for t in tensors)
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)


class TrainDataLoader:
    """Host batches -> device transform -> (images, targets).

    The returned iterable is re-iterable (fresh epoch each time), matching
    the Trainer.fit contract.  The augmentation draws come from one
    ``torch.Generator`` on ``device``, seeded with ``seed``.

    With a ``mesh`` (`parallel.make_mesh`), ``batch_size`` is the global
    batch and each rank gets its slice of every batch (`HostBatcher`'s
    ``shard``), transformed with the global batch's draws; every rank must
    build the loader alike.  `Trainer.fit(mesh=)` takes such a loader.
    """

    def __init__(
        self,
        samples: Sequence[Sample],
        anchors: Anchors,
        encoding: EncodingConfig,
        batch_size: int,
        augmentation_horizontal_flip: bool = False,
        augmentation_rgb: bool = False,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        use_sample_cache: bool = True,
        drop_remainder: bool = True,
        device="cuda",
        mesh=None,
    ) -> None:
        self.device = torch.device(device)
        self.mesh = mesh
        shard = (0, 1)
        if mesh is not None:
            group = mesh_lib.check_mesh(mesh).get_group(mesh_lib.BATCH_AXIS)
            shard = (dist.get_rank(group), dist.get_world_size(group))
        self.batcher = HostBatcher(
            samples,
            batch_size,
            max_ground_truth_boxes=encoding.max_ground_truth_boxes,
            shuffle=shuffle,
            seed=seed,
            num_workers=num_workers,
            image_shape=encoding.image_shape,
            use_sample_cache=use_sample_cache,
            drop_remainder=drop_remainder,
            shard=shard,
        )
        # Trainer.fit runs the transform inside its fused step; __iter__
        # runs it standalone
        self.transform = make_train_batch_transform(
            anchors,
            encoding,
            augmentation_horizontal_flip=augmentation_horizontal_flip,
            augmentation_rgb=augmentation_rgb,
            device=self.device,
            shard=shard,
        )
        self.process = self.transform
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def __len__(self) -> int:
        return len(self.batcher)

    def __iter__(self):
        for batch in self.batcher:
            yield self.process(self._generator, *upload_batch(batch, self.device))

    def iter_raw(self):
        """Yield (generator, (images_u8, masks_u8, gt_labels, gt_boxes,
        gt_valid)) with the batch still on HOST, for transform-fused train
        steps (same random stream as __iter__: the generator is read when
        the transform runs, in batch order).  The consumer controls when
        the transfer happens: Trainer.fit stages uploads in chunks."""
        for batch in self.batcher:
            yield self._generator, tuple(batch)
