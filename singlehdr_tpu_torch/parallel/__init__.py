"""Data-parallel training over ``torch.distributed`` (counterpart of
``singlehdr_tpu.parallel``): one process a device, the data axis only."""

from singlehdr_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    DataMesh,
    global_sum,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "DataMesh",
    "global_sum",
    "initialize_multihost",
    "make_mesh",
    "replicate",
    "shard_batch",
]
