"""Data parallelism over ``torch.distributed``: the mesh, the sharding
helpers, and the scope inside which the batch-global reductions cross ranks.
Counterpart of ssdseglib_tpu/parallel/mesh.py.

The JAX package shards the batch over a `jax.sharding.Mesh` and lets GSPMD
insert every collective.  Here each rank is a process that holds one slice
of the global batch and a replica of the parameters, and the collectives
are written out.  The global batch needs four of them, and a naive
data-parallel port gets the first three wrong:

- train-mode BatchNorm over the global batch (`models/blocks.py`, and the
  statistics and backward of the chain unit, `ops/fused_chain_backward.py`);
- the batch-global hard-negative budget and ranking of the confidence loss
  (`losses.confidence_loss`);
- the batch-global segmentation suppression of serving
  (`layers.SegmentationSuppression`);
- the gradient and metric means of a step (`train.Trainer`).

The first three read the group of the innermost `data_parallel` scope
(`active_group`); outside one they are the single-process code, bit for
bit.  Only ``all_reduce`` and ``broadcast`` are used, on tensors on the
rank's device: gloo runs both on CUDA tensors too, which lets two ranks
share one card, where NCCL refuses that.  Nothing falls back: a group that
does not form, or a collective that fails, raises.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import os
import shutil
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXIS = "data"
SPATIAL_AXIS = "spatial"

# the process group of the innermost `data_parallel` scope
_GROUP: contextvars.ContextVar = contextvars.ContextVar("ssdseglib_data_group", default=None)


def _single_process_group(backend: str) -> None:
    """A world-size-1 default group on a FileStore in a temporary
    directory, removed when the process exits."""
    directory = tempfile.mkdtemp(prefix="ssdseglib-mesh-")
    atexit.register(shutil.rmtree, directory, ignore_errors=True)
    store = dist.FileStore(os.path.join(directory, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_mesh(group: Optional[dist.ProcessGroup] = None, device=None) -> DeviceMesh:
    """1-D data-parallel mesh named ``("data",)`` over ``group`` (default:
    the default group).

    device: this rank's device.  Default: the card ``cuda:LOCAL_RANK``
    (LOCAL_RANK as a launcher such as torchrun sets it, else 0); it raises
    without a card.  A CUDA device becomes the current device, which is
    where the mesh's helpers put tensors (`local_device`).

    Without a default group, one is formed: from the launcher's environment
    (``env://``) where WORLD_SIZE is set, else a world-size-1 group for this
    process alone -- NCCL on the card, gloo on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            _single_process_group(backend)
    if group is None:
        group = dist.group.WORLD
    return DeviceMesh.from_group(group, device.type, mesh_dim_names=(BATCH_AXIS,))


def check_data_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself when it is a 1-D ``("data",)`` mesh; TypeError for
    anything that is no DeviceMesh, NotImplementedError for a mesh with a
    spatial axis, ValueError for any other."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch DeviceMesh (parallel.make_mesh), got {type(mesh)!r}")
    names = tuple(mesh.mesh_dim_names or ())
    if SPATIAL_AXIS in names:
        raise NotImplementedError(
            "spatial (H-axis) parallelism is not ported yet (ROADMAP.md, Queue 1); "
            "use a 1-D ('data',) mesh"
        )
    if names != (BATCH_AXIS,):
        raise ValueError(f"expected a 1-D ('{BATCH_AXIS}',) mesh, got axes {names}")
    return mesh


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card for a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh):
    """Shard the leading (batch) axis over the mesh: DTensor placements."""
    from torch.distributed.tensor import Shard

    check_data_mesh(mesh)
    return (Shard(0),)


def replicate_sharding(mesh: DeviceMesh):
    """Every rank holds the whole value: DTensor placements."""
    from torch.distributed.tensor import Replicate

    check_data_mesh(mesh)
    return (Replicate(),)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's contiguous slice of every batch-leading array of ``tree``
    (the global batch, the same on every rank), as tensors on
    `local_device`.  A leaf that is no array passes through.

    Raises a clear ValueError when a batch is not divisible by the mesh size.
    """
    group = check_data_mesh(mesh).get_group(BATCH_AXIS)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    device = local_device(mesh)

    def take(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        if x.ndim == 0 or x.shape[0] % n != 0:
            raise ValueError(
                f"batch axis of shape {tuple(x.shape)} is not "
                f"divisible by the {n}-device mesh '{BATCH_AXIS}' axis; "
                f"pad the batch or use a divisible batch size"
            )
        b = x.shape[0] // n
        part = x[rank * b:(rank + 1) * b]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(device)

    return _tree_map(take, tree)


def shard_images(mesh: DeviceMesh, images):
    """`shard_batch` of an image batch (B, H, W, C).  A mesh with a spatial
    axis raises NotImplementedError (`check_data_mesh`)."""
    return shard_batch(check_data_mesh(mesh), images)


def replicate(mesh: DeviceMesh, tree):
    """A copy of ``tree`` on `local_device` holding rank 0's values on every
    rank: one broadcast per dtype of one flat buffer, not one per tensor.
    Each tensor keeps its shape, dtype and memory layout."""
    check_data_mesh(mesh)
    group = mesh.get_group(BATCH_AXIS)
    src = dist.get_global_rank(group, 0)
    device = local_device(mesh)
    leaves = [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
    copies = {id(t): torch.empty_like(t, device=device) for t in leaves}
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, same in by_dtype.items():
        flat = torch.empty(sum(t.numel() for t in same), dtype=dtype, device=device)
        views, offset = [], 0
        for t in same:
            views.append(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        torch._foreach_copy_(views, [t.to(device) for t in same])
        dist.broadcast(flat.view(torch.uint8), src=src, group=group)  # bytes: any dtype
        torch._foreach_copy_([copies[id(t)] for t in same], views)
    return _tree_map(lambda x: copies.get(id(x), x) if isinstance(x, torch.Tensor) else x, tree)


@contextlib.contextmanager
def data_parallel(mesh: Optional[DeviceMesh]) -> Iterator[None]:
    """The scope of one step: inside it the batch-global reductions
    (BatchNorm statistics and their backward, hard-negative mining,
    segmentation suppression) reduce over the mesh's group.  ``None`` opens
    no scope.  A backward that runs after the scope closes uses the group its
    forward saw (it is kept with the autograd context)."""
    if mesh is None:
        yield
        return
    token = _GROUP.set(check_data_mesh(mesh).get_group(BATCH_AXIS))
    try:
        yield
    finally:
        _GROUP.reset(token)


def active_group() -> Optional[dist.ProcessGroup]:
    """The group of the innermost `data_parallel` scope, or None."""
    return _GROUP.get()


def all_reduce_(tensor: torch.Tensor, group: dist.ProcessGroup,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` over ``group``; returns ``tensor``."""
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def gather_by_sum(local: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The ranks' equal-sized ``local`` tensors concatenated along dim 0 in
    rank order, on every rank: each rank writes its slice of a zero buffer
    and the buffers are summed (adding zeros is exact)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros((n * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    out[rank * local.shape[0]:(rank + 1) * local.shape[0]] = local
    return all_reduce_(out, group)


def global_moments(x32: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of an f32 NCHW tensor over the global batch
    of ``group``: one all_reduce of [sum x, sum x^2], then Flax's fast
    variance E[x^2] - E[x]^2 clipped at 0, with the global count (the ranks'
    shards are equal)."""
    sums = torch.stack([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))])
    all_reduce_(sums, group)
    n = float(x32.numel() // x32.shape[1] * dist.get_world_size(group))
    mean = sums[0] / n
    return mean, (sums[1] / n - mean * mean).clamp_min(0.0)
