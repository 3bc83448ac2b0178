"""Device parallelism: mesh construction and sharding helpers on
``torch.distributed`` (counterpart of ssdseglib_tpu/parallel).

Data parallelism over a 1-D ``("data",)`` DeviceMesh: one process a rank,
the batch sharded, the parameters replicated, the batch-global reductions
written out as collectives (`mesh`).  Spatial (H-axis) parallelism,
ssdseglib_tpu/parallel/spatial.py, is not ported yet (ROADMAP.md, Queue 1):
its names are missing here.
"""

from ssdseglib_torch.parallel.mesh import (
    BATCH_AXIS,
    batch_sharding,
    make_mesh,
    replicate,
    replicate_sharding,
    shard_batch,
    shard_images,
)

__all__ = [
    "BATCH_AXIS",
    "make_mesh",
    "replicate_sharding",
    "batch_sharding",
    "shard_batch",
    "shard_images",
    "replicate",
]
