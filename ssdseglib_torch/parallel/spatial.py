"""Spatial (H-axis) parallelism over ``torch.distributed``: the rows of every
image, and of the feature maps after it, split over the ranks of a
``"spatial"`` mesh axis, on top of the batch split of `parallel.mesh`.
Counterpart of ssdseglib_tpu/parallel/spatial.py.

Why: batch sharding cannot help single-image latency or memory for very large
inputs; with batch 1 a data-parallel mesh leaves every rank but one idle.

The JAX package shards the height over its mesh and GSPMD inserts every halo
exchange and every partial sum.  Here each rank holds rows of each map, and
the layers that look across rows exchange or reduce them by hand, through the
helpers below, inside a `parallel.mesh.data_parallel` scope:

- windows (every 3x3 conv, stride 1 or 2, dilated or not, and the max pool):
  `window_rows` fetches the rows a rank's output rows read from the ranks that
  own them (`_Halo`), padded SAME *of the global map*;
- bilinear resizes (`resize_bilinear`): half-pixel centres in global
  coordinates, clamped at the global border only;
- means and sums over H and W (ASPP image pooling, `mean_hw`; the mask losses'
  per-sample sums, `sum_over_rows`): all_reduce over the spatial group;
- maps that stop being split (`whole`): gathered over the spatial group in row
  order, as are the detection heads' outputs of a split map.

The row partition (`RowPartition`): a map's level is its output stride s
(the images 1, the stem's output 2, ...), of ceil(H / s) rows and ceil(W / s)
columns.  Level s is split -- rank r of n owns rows [r * rows / n,
(r + 1) * rows / n) -- when level s / 2 is split (level 1 always is:
`shard_images` asks H % n == 0), its rows divide by n, and each shard holds at
least the rows of the widest halo an op at that level reads (1, or the
model's `halos`: the largest ASPP dilation at os16).  Every other level is
whole: each spatial rank holds all its rows and computes it alike
(replicated).  So a map is split until the first level that fails the rule,
gathered once there, and whole from then on.  A map's level is read from its
width, which is never split.

Gradients: every rank backpropagates the loss of its data slice, which every
spatial rank holds whole (the heads' outputs are gathered, the mask losses'
sums all-reduced).  So the gradient of a whole map is its true gradient on
every rank and that of a split map n times its true one: each collective's
backward is the adjoint of its forward (a gather's sums and keeps this rank's
rows, an all_reduce's all-reduces, a halo's adds the halo rows' gradients at
their owners), and the step into split compute from a whole map divides by n
(`_ToRows`).  The step's gradient mean over every rank of the mesh then sums
the spatial ranks' partial gradients of a layer on split maps, takes the one
value of a layer on whole maps, and averages over the data ranks
(`train.Trainer`).  BatchNorm on a split map reduces over the whole mesh; on
a whole map over the data group, so the copies are never counted as samples.

Only ``all_reduce`` is used (`parallel/mesh.py`): a halo goes through a zeroed
(n, 2, k, ...) buffer, one slot per rank and edge, summed.  It runs on gloo
with CUDA tensors, where several ranks share one card.

The hand-written kernels pad SAME inside the kernel, which is right at the
global border and wrong at a shard's inner edge, so each runs on this rank's
WINDOW of rows -- its own rows plus the halo rows its output reads, fetched
from the neighbours -- and pads only at the global border:
- the fused MBConv and the stem + block 1 kernels take `edge_window`'s
  window, real rows at inner edges and none past the global border, and run
  unchanged: each pads the window's edges itself, and the output rows it
  gets wrong there are the halo rows' outputs, which are dropped;
- the depthwise and chain backward kernels take `window_rows`' window of a
  stride-1 3x3 conv (fill 0 past the global border) and the rank's own rows
  of dy, padded by a zero row at each end; the chain's BatchNorm gradient
  is confined to the own rows (its kernel's valid-row range);
- the int8 1x1 needs no halo and runs on a shard's rows as they are.
A map level that stays whole runs every kernel whole on every rank.

Usage:
    mesh = spatial.make_hybrid_mesh(n_data=2, n_spatial=2, device=...)
    model = builder.get_model_for_inference(..., mesh=mesh)  # images are
    # split, batch over 'data' and rows over 'spatial', by the model; the
    # Trainer's init_state / fit take the mesh the same way.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.parallel.mesh import BATCH_AXIS

# the mesh axis that splits the rows (named in parallel/mesh.py, which checks
# meshes)
SPATIAL_AXIS = mesh_lib.SPATIAL_AXIS


def make_hybrid_mesh(n_data: int, n_spatial: int, group: Optional[dist.ProcessGroup] = None,
                     device=None) -> DeviceMesh:
    """2-D ``("data", "spatial")`` mesh: the batch split over ``n_data``
    groups of ranks, the image rows ``n_spatial`` ways inside each.  Rank
    ``d * n_spatial + s`` of ``group`` (default: the default group) sits at
    (d, s), as the JAX package's ``reshape(n_data, n_spatial)`` lays out its
    devices; the first ``n_data * n_spatial`` ranks are used.  ``device`` and
    the default group are found as `parallel.make_mesh` finds them.  Every
    rank of the default group calls it (it forms the axes' groups).
    ``n_data=1`` gives pure spatial parallelism (single-image latency);
    ``n_spatial=1`` the data-parallel mesh with a second axis of size 1."""
    device = mesh_lib.rank_device(device)
    ranks = dist.get_process_group_ranks(dist.group.WORLD if group is None else group)
    if n_data * n_spatial > len(ranks):
        raise ValueError(
            f"mesh {n_data}x{n_spatial} needs {n_data * n_spatial} devices, have {len(ranks)}"
        )
    grid = torch.tensor(ranks[:n_data * n_spatial]).reshape(n_data, n_spatial)
    mesh = DeviceMesh(device.type, grid, mesh_dim_names=(BATCH_AXIS, SPATIAL_AXIS))
    if mesh.size() < dist.get_world_size():
        mesh._flatten()  # the group of the mesh's ranks (`mesh_group`), formed by every rank
    return mesh


def has_spatial_axis(mesh: DeviceMesh) -> bool:
    return SPATIAL_AXIS in tuple(mesh.mesh_dim_names or ())


def image_sharding(mesh: DeviceMesh):
    """DTensor placements of (B, H, W, C) image batches: batch over 'data',
    height over 'spatial' when the mesh has one (plain batch sharding
    otherwise)."""
    from torch.distributed.tensor import Shard

    if has_spatial_axis(mesh_lib.check_mesh(mesh)):
        return (Shard(0), Shard(1))
    return (Shard(0),)


def _check_height(shape, dim: int, n: int) -> None:
    if shape[dim] % n != 0:
        raise ValueError(
            f"height axis of shape {tuple(shape)} is not divisible by "
            f"the {n}-device mesh '{SPATIAL_AXIS}' axis"
        )


def shard_rows(mesh: DeviceMesh, x, dim: int = 1):
    """This rank's rows (axis ``dim``) of ``x`` over the mesh's spatial axis,
    as a tensor on the mesh's device; ``x`` itself, as a tensor there, when
    the rows are not split.  ValueError when the height does not divide."""
    n = mesh_lib.spatial_size(mesh)
    _check_height(x.shape, dim, n)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if n > 1:
        rank = dist.get_rank(mesh.get_group(SPATIAL_AXIS))
        h = x.shape[dim] // n
        x = x.narrow(dim, rank * h, h)
    return x.to(mesh_lib.local_device(mesh))


def shard_images(mesh: DeviceMesh, images, batch_is_local: bool = False):
    """This rank's block of an image batch (B, H, W, C), with the JAX
    package's divisibility errors (batch % data axis, height % spatial
    axis): its slice of the batch (`parallel.shard_batch`; taken already
    when ``batch_is_local``) and, with a spatial axis, its rows
    (`shard_rows`)."""
    n_data = dist.get_world_size(mesh_lib.check_mesh(mesh).get_group(BATCH_AXIS))
    if images.ndim < 2 or (not batch_is_local and images.shape[0] % n_data != 0):
        raise ValueError(
            f"batch axis of shape {tuple(getattr(images, 'shape', ()))} is not "
            f"divisible by the {n_data}-device mesh '{BATCH_AXIS}' axis; "
            f"pad the batch or use a divisible batch size"
        )
    _check_height(images.shape, 1, mesh_lib.spatial_size(mesh))
    if not batch_is_local:
        images = mesh_lib.shard_batch(mesh, images)
    return shard_rows(mesh, images)


def same_pad(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """TF/XLA SAME padding (before, after) of one spatial axis."""
    effective = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


class RowPartition:
    """Which global rows of each feature map this rank owns (the rule is the
    module docstring's): levels of output stride 1, 2, 4, ... down to a 1x1
    map, each split or whole."""

    def __init__(self, height: int, width: int, n: int, rank: int,
                 halos: Optional[Dict[int, int]] = None) -> None:
        self.height, self.width, self.n, self.rank = height, width, n, rank
        self.levels = []  # (stride, rows, columns, split)
        split, stride = True, 1
        while True:
            rows, cols = -(-height // stride), -(-width // stride)
            split = split and rows % n == 0 and rows // n >= (halos or {}).get(stride, 1)
            self.levels.append((stride, rows, cols, split))
            if rows == 1 and cols == 1:
                break
            stride *= 2
        # columns -> rows of the split levels, whose widths are all distinct
        self._split = {cols: rows for _, rows, cols, split in self.levels if split}

    def first_whole(self) -> Optional[int]:
        """The output stride of the first whole level (None: none is)."""
        return next((stride for stride, _, _, split in self.levels if not split), None)

    def is_split(self, rows: int, cols: int) -> bool:
        """Whether a map of ``rows`` x ``cols`` global rows and columns is
        split."""
        return self._split.get(cols) == rows

    def rows_of(self, x: torch.Tensor) -> Optional[int]:
        """The global rows of the NCHW map ``x`` when this rank holds a split
        shard of it (rows [rank * h, (rank + 1) * h) with h = x's rows), or
        None when ``x`` is whole."""
        rows = self._split.get(x.shape[3])
        if rows is None or x.shape[2] * self.n != rows:
            return None
        return rows


def _partition() -> Tuple[Optional[RowPartition], Optional[mesh_lib.Groups]]:
    groups = mesh_lib.active_groups()
    if groups is None or groups.partition is None:
        return None, groups
    return groups.partition, groups


@contextlib.contextmanager
def row_partition(images: torch.Tensor, halos: Optional[Dict[int, int]] = None) -> Iterator[None]:
    """The row partition of a forward on ``images`` (this rank's NHWC block)
    for the length of the block, inside a scope whose rows are split;
    nothing otherwise.  ``halos``: {output stride: rows} of ops that read
    more than one row across a shard's edge (a dilated conv)."""
    groups = mesh_lib.active_groups()
    if groups is None or groups.spatial is None:
        yield
        return
    n, rank = dist.get_world_size(groups.spatial), dist.get_rank(groups.spatial)
    partition = RowPartition(images.shape[1] * n, images.shape[2], n, rank, halos)
    with mesh_lib.partitioned(partition):
        yield


def _exchange_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 for f64, else f32: the dtype of the exchanges and sums (gloo sums
    both on any device; a zero plus one value is exact in f32 for every lower
    float dtype) and of the arithmetic that the library takes in f32 for
    low-precision inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _memory_format(x: torch.Tensor):
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _swap(first: torch.Tensor, last: torch.Tensor, group, rank: int, n: int):
    """Every rank's ``first`` and ``last`` blocks (one shape on every rank)
    through ONE all_reduce of a zeroed (n, 2, ...) buffer: returns the last
    block of the rank above and the first block of the rank below (None past
    the ends)."""
    buffer = first.new_zeros((n, 2) + tuple(first.shape), dtype=_exchange_dtype(first.dtype))
    buffer[rank, 0] = first
    buffer[rank, 1] = last
    dist.all_reduce(buffer, group=group)
    above = buffer[rank - 1, 1].to(first.dtype) if rank > 0 else None
    below = buffer[rank + 1, 0].to(first.dtype) if rank + 1 < n else None
    return above, below


class _Halo(torch.autograd.Function):
    """x (B, C, h, W), this rank's rows of a split map, with ``top`` rows of
    the rank above and ``bottom`` rows of the rank below around it (both at
    most h); past the map's first and last rows, ``fill``.  Backward: the halo
    rows' gradients go back to the ranks that own the rows and are added
    there."""

    @staticmethod
    def forward(ctx, x, top, bottom, fill, group, rank, n):
        b, c, h, w = x.shape
        k = max(top, bottom)
        above, below = _swap(x[:, :, :k], x[:, :, h - k:], group, rank, n)
        out = torch.empty((b, c, top + h + bottom, w), dtype=x.dtype, device=x.device,
                          memory_format=_memory_format(x))
        out[:, :, top:top + h] = x
        out[:, :, :top] = fill if above is None else above[:, :, k - top:]
        out[:, :, top + h:] = fill if below is None else below[:, :, :bottom]
        ctx.args = (top, bottom, group, rank, n)
        return out

    @staticmethod
    def backward(ctx, g):
        top, bottom, group, rank, n = ctx.args
        h = g.shape[2] - top - bottom
        k = max(top, bottom)
        up = g.new_zeros(g.shape[:2] + (k, g.shape[3]))  # to the rank above's last rows
        up[:, :, k - top:] = g[:, :, :top]
        down = g.new_zeros(g.shape[:2] + (k, g.shape[3]))  # to the rank below's first rows
        down[:, :, :bottom] = g[:, :, top + h:]
        from_above, from_below = _swap(up, down, group, rank, n)
        dx = g[:, :, top:top + h].clone(memory_format=_memory_format(g))
        if from_above is not None:
            dx[:, :, :bottom] += from_above[:, :, :bottom]
        if from_below is not None:
            dx[:, :, h - top:] += from_below[:, :, k - top:]
        return dx, None, None, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """The whole map on every rank from the ranks' equal row blocks (dim 2),
    in row order.  Backward: the whole map's gradient summed over the ranks,
    this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        dtype = _exchange_dtype(x.dtype)
        whole = mesh_lib.gather_by_sum(x.to(dtype), group, dim=2).to(x.dtype)
        ctx.args = (group, rank, x.shape[2])
        return whole.contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        group, rank, h = ctx.args
        total = mesh_lib.all_reduce_(g.to(_exchange_dtype(g.dtype), copy=True), group)
        return (total[:, :, rank * h:(rank + 1) * h].to(g.dtype)
                .contiguous(memory_format=_memory_format(g)), None, None, None)


class _ToRows(torch.autograd.Function):
    """A whole map entering split compute (each rank reads only its rows of
    it): the identity forward; backward, the ranks' gradients summed and
    divided by their number, which gives the whole map's true gradient on
    every rank (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        total = mesh_lib.all_reduce_(g.to(_exchange_dtype(g.dtype), copy=True), group)
        return total.div_(n).to(g.dtype), None, None


class _SumOverRanks(torch.autograd.Function):
    """all_reduce (sum) over ``group``, whose adjoint is the same
    all_reduce of the gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return mesh_lib.all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce_(g.clone(), ctx.group), None


def _fetch_rows(x: torch.Tensor, partition: RowPartition, group,
                need: Callable[[int], Tuple[int, int]], fill: float) -> torch.Tensor:
    """Global rows [need(rank)) of the split map ``x`` (this rank's shard),
    rows past the map's edges ``fill``.  Every rank's window is known to
    every rank, so all agree on the halo's depth."""
    n, rank, h = partition.n, partition.rank, x.shape[2]
    top = max(max(r * h - need(r)[0] for r in range(n)), 0)
    bottom = max(max(need(r)[1] - (r + 1) * h for r in range(n)), 0)
    if max(top, bottom) > h:
        raise RuntimeError(
            f"a window reads {max(top, bottom)} rows across a shard's edge, more than the "
            f"shard's {h}: the row partition's halos are too small"
        )
    if top or bottom:
        x = _Halo.apply(x, top, bottom, fill, group, rank, n)
    start, stop = need(rank)
    base = rank * h - top
    return x[:, :, start - base:stop - base]


def window_rows(x: torch.Tensor, kernel: int, stride: int, dilation: int,
                fill: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The input of a SAME window op along H (conv, max pool) and its row
    padding (before, after), such that the op with that padding gives this
    rank's output rows of the global map: ``x`` and its SAME padding outside
    a row partition or for a whole map; for a split map whose output level
    is split, the window of global rows its output rows read, fetched from
    the neighbours and padded past the global edges with ``fill``, and no
    padding; for one whose output level is whole, the whole map (gathered
    here) and its SAME padding."""
    partition, groups = _partition()
    rows = None if partition is None else partition.rows_of(x)
    if rows is None:
        return x, same_pad(x.shape[2], kernel, stride, dilation)
    out_rows, out_cols = -(-rows // stride), -(-x.shape[3] // stride)
    if not partition.is_split(out_rows, out_cols):
        return whole(x), same_pad(rows, kernel, stride, dilation)
    h_out = out_rows // partition.n
    effective = (kernel - 1) * dilation + 1
    pad = same_pad(rows, kernel, stride, dilation)[0]

    def need(r):
        return (r * h_out * stride - pad, ((r + 1) * h_out - 1) * stride - pad + effective)

    return _fetch_rows(x, partition, groups.spatial, need, fill), (0, 0)


class Window(NamedTuple):
    """A split map's window of rows (`edge_window`): ``rows`` (B, C, top +
    h + bottom, W) holds global rows [first, first + top + h + bottom), of
    which [own_first, own_first + h) are this rank's; ``height`` is the
    map's global rows."""

    rows: torch.Tensor
    top: int
    bottom: int
    first: int
    own_first: int
    height: int


def edge_window(x: torch.Tensor, before: int, after: int) -> Optional[Window]:
    """The window of a kernel that pads SAME itself: for a split NCHW map
    ``x`` (this rank's shard), global rows [start - before, stop + after)
    clipped to the map -- real rows at inner edges, none past the global
    border -- fetched from the neighbours (`_Halo`, whose backward returns
    the halo rows' gradients to their owners).  None when ``x`` is whole or
    outside a row partition."""
    partition, groups = _partition()
    rows = None if partition is None else partition.rows_of(x)
    if rows is None:
        return None
    h = x.shape[2]

    def need(r):
        return max(r * h - before, 0), min((r + 1) * h + after, rows)

    start, stop = need(partition.rank)
    own = partition.rank * h
    return Window(_fetch_rows(x, partition, groups.spatial, need, 0.0), own - start,
                  stop - own - h, start, own, rows)


def split_at(rows: int, cols: int) -> bool:
    """Whether a map of ``rows`` x ``cols`` global rows and columns is split
    under the active row partition (False outside one)."""
    partition, _ = _partition()
    return partition is not None and partition.is_split(rows, cols)


def split_group(x: torch.Tensor):
    """The group whose ranks hold ``x``'s samples and rows together, as a
    batch statistic of ``x`` reduces: every rank of the mesh for a split map,
    the data group for a whole one (its spatial copies are no samples); None
    outside a `parallel.mesh.data_parallel` scope."""
    groups = mesh_lib.active_groups()
    if groups is None:
        return None
    split = groups.partition is not None and groups.partition.rows_of(x) is not None
    return groups.whole if split else groups.data


def own_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the GLOBAL NCHW map ``t`` when its level is split
    (a constant of the global map, such as a bias map, met by split
    compute), ``t`` itself otherwise."""
    partition, _ = _partition()
    if partition is None or not partition.is_split(t.shape[2], t.shape[3]):
        return t
    h = t.shape[2] // partition.n
    return t[:, :, partition.rank * h:(partition.rank + 1) * h]


def whole(x: torch.Tensor) -> torch.Tensor:
    """The whole NCHW map ``x``: gathered over the spatial group in row
    order when this rank holds a split shard of it, ``x`` itself
    otherwise."""
    partition, groups = _partition()
    if partition is None or partition.rows_of(x) is None:
        return x
    return _GatherRows.apply(x, groups.spatial, partition.rank, partition.n)


def global_size(x: torch.Tensor) -> Tuple[int, int]:
    """The global (rows, columns) of the NCHW map ``x``."""
    partition, _ = _partition()
    rows = None if partition is None else partition.rows_of(x)
    return (x.shape[2] if rows is None else rows), x.shape[3]


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=(2, 3), keepdim=True)`` over the global map (a whole
    (B, C, 1, 1) result): a split map's sums are all-reduced over the
    spatial group and divided by the global count."""
    partition, groups = _partition()
    rows = None if partition is None else partition.rows_of(x)
    if rows is None:
        return x.mean(dim=(2, 3), keepdim=True)
    total = _SumOverRanks.apply(x.to(_exchange_dtype(x.dtype)).sum(dim=(2, 3), keepdim=True),
                                groups.spatial)
    return (total / (rows * x.shape[3])).to(x.dtype)


def expand_rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole (B, C, 1, 1) ``x`` broadcast over ``like``'s rows and
    columns; entering split compute when ``like`` is a split shard
    (`_ToRows`)."""
    partition, groups = _partition()
    if partition is not None and partition.rows_of(like) is not None:
        x = _ToRows.apply(x, groups.spatial, partition.n)
    return x.expand(-1, -1, like.shape[2], like.shape[3])


def sum_over_rows(t: torch.Tensor) -> torch.Tensor:
    """Per-sample sums over this rank's rows of a row-split map (the images'
    level is always split) summed over the spatial group inside a scope
    whose rows are split; ``t`` otherwise."""
    groups = mesh_lib.active_groups()
    if groups is None or groups.spatial is None:
        return t
    return _SumOverRanks.apply(t, groups.spatial)


def _source_rows(size_in: int, size_out: int, start: int, stop: int, dtype=np.float32):
    """Bilinear (half-pixel centres) source rows and weights of output rows
    [start, stop), as ``F.interpolate(..., align_corners=False)`` takes them
    in ``dtype``: (first row, second row, weight of the second)."""
    scale = dtype(size_in) / dtype(size_out)
    src = np.maximum(scale * (np.arange(start, stop, dtype=dtype) + dtype(0.5)) - dtype(0.5),
                     dtype(0.0))
    first = src.astype(np.int64)
    second = np.minimum(first + 1, size_in - 1)
    return first, second, src - first.astype(dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of the NCHW map ``x`` to the GLOBAL size (height,
    width), half-pixel centres, clamped at the global border; this rank's
    rows of the result when that level is split, the whole result
    otherwise."""
    partition, groups = _partition()
    rows = None if partition is None else partition.rows_of(x)
    if partition is None or not partition.is_split(height, width):
        return F.interpolate(whole(x), size=(height, width), mode="bilinear",
                             align_corners=False)
    size_in = x.shape[2] if rows is None else rows
    h_out = height // partition.n
    dtype = _exchange_dtype(x.dtype)
    first, second, weight = _source_rows(size_in, height, partition.rank * h_out,
                                         (partition.rank + 1) * h_out,
                                         np.float64 if dtype == torch.float64 else np.float32)
    if rows is None:
        x, base = _ToRows.apply(x, groups.spatial, partition.n), 0
    else:
        def need(r):
            f, s, _ = _source_rows(size_in, height, r * h_out, (r + 1) * h_out)
            return int(f.min()), int(s.max()) + 1

        base = need(partition.rank)[0]
        x = _fetch_rows(x, partition, groups.spatial, need, 0.0)
    index = torch.from_numpy(np.concatenate([first, second]) - base).to(x.device)
    pair = x.to(dtype).index_select(2, index)
    lam = torch.from_numpy(weight).to(x.device).view(1, 1, -1, 1)
    y = pair[:, :, :h_out] * (1.0 - lam) + pair[:, :, h_out:] * lam
    y = F.interpolate(y, size=(h_out, width), mode="bilinear", align_corners=False)
    return y.to(x.dtype).contiguous(memory_format=_memory_format(x))
