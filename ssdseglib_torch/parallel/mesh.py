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

A mesh is 1-D ``("data",)`` (`make_mesh`) or 2-D ``("data", "spatial")``
(`parallel.spatial.make_hybrid_mesh`), whose second axis splits the rows of
every image and feature map (`parallel/spatial.py`).  The reductions read the
groups of the innermost `data_parallel` scope (`active_groups`); outside one
they are the single-process code, bit for bit.  Only ``all_reduce`` and
``broadcast`` are used, on tensors on the rank's device: gloo runs both on
CUDA tensors too, which lets several ranks share one card, where NCCL
refuses that.  Nothing falls back: a group that does not form, or a
collective that fails, raises.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Groups:
    """The process groups of one `data_parallel` scope.

    data: the ranks that hold the other slices of the batch (and the same
    rows); whole: every rank of the mesh; spatial: the ranks that hold the
    other rows of the same images, None when the rows are not split (no
    spatial axis, or one of size 1); partition: the row partition of the
    model's forward (`parallel.spatial.RowPartition`), set by the model for
    the length of its forward."""

    data: dist.ProcessGroup
    whole: dist.ProcessGroup
    spatial: Optional[dist.ProcessGroup] = None
    partition: Optional[object] = None


# the groups of the innermost `data_parallel` scope
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("ssdseglib_mesh_scope", default=None)


def _single_process_group(backend: str) -> None:
    """A world-size-1 default group on a FileStore in a temporary
    directory, removed when the process exits."""
    directory = tempfile.mkdtemp(prefix="ssdseglib-mesh-")
    atexit.register(shutil.rmtree, directory, ignore_errors=True)
    store = dist.FileStore(os.path.join(directory, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def rank_device(device=None) -> torch.device:
    """This rank's device, made the current one, with the default group
    formed where there is none.

    device: default the card ``cuda:LOCAL_RANK`` (LOCAL_RANK as a launcher
    such as torchrun sets it, else 0); it raises without a card.

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
    return device


def make_mesh(group: Optional[dist.ProcessGroup] = None, device=None) -> DeviceMesh:
    """1-D data-parallel mesh named ``("data",)`` over ``group`` (default:
    the default group), on this rank's device (`rank_device`).  A CUDA device
    becomes the current device, which is where the mesh's helpers put
    tensors (`local_device`)."""
    device = rank_device(device)
    if group is None:
        group = dist.group.WORLD
    return DeviceMesh.from_group(group, device.type, mesh_dim_names=(BATCH_AXIS,))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself when it is a ``("data",)`` or ``("data", "spatial")``
    DeviceMesh; TypeError for anything that is no DeviceMesh, ValueError for
    any other axes."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch DeviceMesh (parallel.make_mesh), got {type(mesh)!r}")
    names = tuple(mesh.mesh_dim_names or ())
    if names not in ((BATCH_AXIS,), (BATCH_AXIS, SPATIAL_AXIS)):
        raise ValueError(
            f"expected a ('{BATCH_AXIS}',) or ('{BATCH_AXIS}', '{SPATIAL_AXIS}') mesh, got "
            f"axes {names}"
        )
    return mesh


def spatial_size(mesh: DeviceMesh) -> int:
    """How many ranks split an image's rows: the size of the mesh's spatial
    axis, 1 without one."""
    if check_mesh(mesh).ndim == 1:
        return 1
    return mesh.size(1)


def mesh_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of every rank of ``mesh``: the data group of a 1-D mesh;
    the default group when a 2-D mesh holds every rank, else the mesh
    flattened (formed at the first call, which every rank of the default
    group makes)."""
    if check_mesh(mesh).ndim == 1:
        return mesh.get_group(BATCH_AXIS)
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    return mesh._flatten().get_group()


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card for a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh):
    """Shard the leading (batch) axis over the data axis, replicate over a
    spatial one: DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0),) + (Replicate(),) * (check_mesh(mesh).ndim - 1)


def replicate_sharding(mesh: DeviceMesh):
    """Every rank holds the whole value: DTensor placements."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * check_mesh(mesh).ndim


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
    """This rank's contiguous slice over the data axis of every
    batch-leading array of ``tree`` (the global batch, the same on every
    rank), as tensors on `local_device`.  A leaf that is no array passes
    through.

    Raises a clear ValueError when a batch is not divisible by the data axis.
    """
    group = check_mesh(mesh).get_group(BATCH_AXIS)
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


def shard_images(mesh: DeviceMesh, images, batch_is_local: bool = False):
    """This rank's block of an image batch (B, H, W, C): its slice of the
    batch over the data axis and, when the mesh has a spatial axis, its rows
    over that axis (`parallel.spatial.shard_images`).  `shard_batch` on a
    1-D mesh.  ``batch_is_local``: the batch is this rank's slice already
    (what a loader built with the mesh yields), and only the rows are taken."""
    from ssdseglib_torch.parallel import spatial

    return spatial.shard_images(mesh, images, batch_is_local=batch_is_local)


def replicate(mesh: DeviceMesh, tree):
    """A copy of ``tree`` on `local_device` holding the values of the mesh's
    first rank on every rank: one broadcast per dtype of one flat buffer, not
    one per tensor.  Each tensor keeps its shape, dtype and memory layout."""
    group = mesh_group(mesh)
    src = int(mesh.mesh.flatten()[0])
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
    segmentation suppression) reduce over the mesh's groups, and on a mesh
    whose spatial axis splits the rows the model's layers exchange and
    reduce rows (`parallel.spatial`).  ``None`` opens no scope.  A backward
    that runs after the scope closes uses the groups its forward saw (they
    are kept with the autograd context)."""
    if mesh is None:
        yield
        return
    spatial = spatial_size(mesh) > 1
    groups = Groups(data=mesh.get_group(BATCH_AXIS), whole=mesh_group(mesh),
                    spatial=mesh.get_group(SPATIAL_AXIS) if spatial else None)
    token = _SCOPE.set(groups)
    try:
        yield
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def partitioned(partition) -> Iterator[None]:
    """The innermost scope with ``partition`` as its row partition, for the
    length of the block (`parallel.spatial.row_partition`)."""
    token = _SCOPE.set(dataclasses.replace(_SCOPE.get(), partition=partition))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def active_groups() -> Optional[Groups]:
    """The groups of the innermost `data_parallel` scope, or None."""
    return _SCOPE.get()


def active_group() -> Optional[dist.ProcessGroup]:
    """The data group of the innermost `data_parallel` scope, or None."""
    groups = _SCOPE.get()
    return None if groups is None else groups.data


def all_reduce_(tensor: torch.Tensor, group: dist.ProcessGroup,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` over ``group``; returns ``tensor``."""
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def gather_by_sum(local: torch.Tensor, group: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-sized ``local`` tensors concatenated along ``dim`` in
    rank order, on every rank: each rank writes its slice of a zero buffer
    and the buffers are summed (adding zeros is exact)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    size = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * size
    out = local.new_zeros(shape)
    out.narrow(dim, rank * size, size).copy_(local)
    return all_reduce_(out, group)


def global_moments(x32: torch.Tensor, group, count: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of an f32 NCHW tensor over ``group``, whose
    ranks hold ``count`` values a channel together: one all_reduce of
    [sum x, sum x^2], then Flax's fast variance E[x^2] - E[x]^2 clipped at
    0."""
    sums = torch.stack([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))])
    all_reduce_(sums, group)
    mean = sums[0] / count
    return mean, (sums[1] / count - mean * mean).clamp_min(0.0)
