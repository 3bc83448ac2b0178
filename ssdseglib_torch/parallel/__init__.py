"""Device parallelism: mesh construction and sharding helpers on
``torch.distributed`` (counterpart of ssdseglib_tpu/parallel).

Data parallelism over a ``("data",)`` DeviceMesh (`mesh`): one process a
rank, the batch sharded, the parameters replicated, the batch-global
reductions written out as collectives.  Spatial (H-axis) parallelism over a
``("data", "spatial")`` DeviceMesh (`spatial`): the image rows split over the
second axis too, with the halo exchanges and the reductions over H written
out by hand.
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
from ssdseglib_torch.parallel.spatial import (
    SPATIAL_AXIS,
    image_sharding,
    make_hybrid_mesh,
)

__all__ = [
    "BATCH_AXIS",
    "SPATIAL_AXIS",
    "make_mesh",
    "make_hybrid_mesh",
    "replicate_sharding",
    "batch_sharding",
    "image_sharding",
    "shard_batch",
    "shard_images",
    "replicate",
]
