"""The shard groups of the sharded backend and their collectives; the
dry-run's placements (``PartitionSpec``, ``shard_shape``); the GPipe
schedule over a stacked ``pipe`` axis."""
from repro_torch.distributed import pipeline
from repro_torch.distributed.mesh import (GridMesh, Mesh, PartitionSpec,
                                          all_gather, all_to_all, axis_size,
                                          pmax, psum, shard_shape)

__all__ = ["Mesh", "GridMesh", "PartitionSpec", "axis_size", "shard_shape",
           "psum", "pmax", "all_gather", "all_to_all", "pipeline"]
