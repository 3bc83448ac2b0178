"""Shared NumPy-out serving conventions (from ssdseglib_tpu/utils/serving.py).

- `format_outputs`: the mask-dtype coercion + optional background-box
  filter (reference layers.py:165-166) applied to every NumPy-out predict.
- `predict_batched_chunks` / `predict_batched_chunks_multi`: the any-N
  chunk / repeat-pad / slice loop that serves an arbitrary number of images
  through one batch size, or through several (`plan_batched_chunks`).
- `stage_input`: the pinned, non-blocking upload of a host batch.
- `gather_outputs`: a mesh model's blocks of one batch, whole on every
  rank.

Both the live `InferenceModel` (models/builder.py) and the reloaded
`ServingBundle` (export.py) use them, so the two cannot drift.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()  # numpy has no bfloat16
        return a.cpu().numpy()
    return np.asarray(a)


def format_outputs(
    mask, det, suppress_background: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy-out conventions shared by every predict surface: bf16 masks
    come back as float32 (numpy has no bfloat16), 'class_map' uint8 passes
    through, and the optional host-side background-box filter (reference
    layers.py:165-166) drops label-0 rows."""
    mask, det = _to_numpy(mask), _to_numpy(det)
    if mask.dtype != np.uint8 and mask.dtype != np.float32:
        mask = mask.astype(np.float32)
    if suppress_background:
        det = det[det[..., 0] > 0.0]
    return mask, det


def predict_batched_chunks(
    images,
    batch: int,
    run_chunk: Callable[[np.ndarray], Tuple[object, object]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Serve an arbitrary number of images at one batch size.

    Chunks the input into `batch`-size pieces and pads the ragged tail BY
    REPEATING ITS LAST IMAGE, then slices outputs back to the real rows.
    Repeat-padding (not zero-padding) is what keeps the real rows exact
    under the reference's batch-global segmentation suppression (reference
    layers.py:207): a duplicate image adds no new classes to the batch
    presence set, while a zero/blank pad image could.  As with Keras
    `predict` over a batched dataset (reference nb 03 cell 25), the
    batch-global quirk applies per served chunk.

    `run_chunk(chunk)` executes one full `(batch, H, W, C)` chunk and
    returns `(mask, det)` (device tensors or host arrays).  Output-convention
    formatting (`format_outputs`) is the caller's job — padded rows must
    be sliced by position BEFORE any background filter drops real rows.
    """
    images = np.asarray(images)
    if images.ndim != 4:
        raise ValueError(
            f"predict_batched expects (N, H, W, C) images, got "
            f"shape {images.shape}"
        )
    if not isinstance(batch, int) or isinstance(batch, bool) or batch < 1:
        raise ValueError(f"batch must be a positive int, got {batch!r}")
    return predict_batched_chunks_multi(images, (batch,), run_chunk)


def plan_batched_chunks(n: int, sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """Chunk plan for serving `n` images through programs baked at
    `sizes`: a list of (real_rows, program_batch) pairs, greedily using
    the largest program that fits the remaining rows, then padding the
    ragged tail up to the smallest program.  A b1+b16 bundle thus serves
    one image at b1 compute (not 16x repeat-padded), and e.g. 35 images
    as 16+16+1+1+1 with zero padded rows."""
    if n < 1:
        raise ValueError("plan_batched_chunks needs n >= 1")
    sizes = sorted(set(int(s) for s in sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"program batch sizes must be positive, got {sizes}")
    plan: List[Tuple[int, int]] = []
    remaining = n
    while remaining > 0:
        fits = [s for s in sizes if s <= remaining]
        if fits:
            plan.append((fits[-1], fits[-1]))
        else:
            # remaining < smallest program: pad up to it
            plan.append((remaining, sizes[0]))
        remaining -= plan[-1][0]
    return plan


def predict_batched_chunks_multi(
    images,
    batches: Sequence[int],
    run_chunk: Callable[[np.ndarray], Tuple[object, object]],
) -> Tuple[np.ndarray, np.ndarray]:
    """`predict_batched_chunks` over SEVERAL program batch sizes: each
    chunk handed to `run_chunk` has a shape[0] from `batches`, chosen by
    `plan_batched_chunks` (largest-fit, minimal tail padding)."""
    images = np.asarray(images)
    if images.ndim != 4:
        raise ValueError(
            f"predict_batched expects (N, H, W, C) images, got "
            f"shape {images.shape}"
        )
    for b in batches:
        if not isinstance(b, (int, np.integer)) or isinstance(b, bool) or b < 1:
            raise ValueError(f"batch must be a positive int, got {b!r}")
    if images.shape[0] == 0:
        raise ValueError("predict_batched got an empty image stack")

    masks, dets = [], []
    start = 0
    for k, b in plan_batched_chunks(images.shape[0], batches):
        chunk = images[start : start + k]
        start += k
        if k < b:
            pad = np.repeat(chunk[-1:], b - k, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        mask, det = run_chunk(chunk)
        # slice BEFORE any host-side filter: padded rows are dropped by
        # position, real rows (later) by the background filter
        masks.append(_to_numpy(mask)[:k])
        dets.append(_to_numpy(det)[:k])
    return np.concatenate(masks, 0), np.concatenate(dets, 0)


def gather_outputs(mask: torch.Tensor, det: torch.Tensor, mesh):
    """(mask, det) of the whole batch on every rank of ``mesh`` from each
    rank's block: the mask's rows over a spatial axis that splits them, then
    mask and detections over the data axis, an all_reduce into a zero buffer
    each (f32, which holds every served dtype's values exactly; a uint8
    class map comes back uint8, a bf16 mask as f32, which `format_outputs`
    makes of it anyway)."""
    from ssdseglib_torch.parallel import mesh as mesh_lib

    whole = mask.float()
    if mesh_lib.spatial_size(mesh) > 1:
        whole = mesh_lib.gather_by_sum(whole, mesh.get_group(mesh_lib.SPATIAL_AXIS), dim=1)
    data = mesh.get_group(mesh_lib.BATCH_AXIS)
    whole = mesh_lib.gather_by_sum(whole, data)
    if mask.dtype == torch.uint8:
        whole = whole.to(torch.uint8)
    return whole, mesh_lib.gather_by_sum(det, data)


def stage_input(images, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: NumPy goes through pinned host memory
    with a non-blocking upload; a tensor is moved as it is."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if images.device == device:
        return images
    if device.type == "cuda" and images.device.type == "cpu":
        images = images.pin_memory()
    return images.to(device, non_blocking=True)
