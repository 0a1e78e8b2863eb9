"""Data- and spatial-parallel training and inference over ``torch.distributed``
(counterpart of ``singlehdr_tpu.parallel``): one process a device, a mesh of
D data indices x S bands of image rows."""

from singlehdr_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    DataMesh,
    global_sum,
    halo_rows,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
    spatial_sum,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "DataMesh",
    "global_sum",
    "halo_rows",
    "initialize_multihost",
    "make_mesh",
    "replicate",
    "shard_batch",
    "spatial_sum",
]
