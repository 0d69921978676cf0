"""The meshes (shard groups of the sharded backend, position groups of
several axes) and their collectives; the dry-run's placements
(``PartitionSpec``, ``shard_shape``); the GPipe schedule over the groups
of a ``pipe`` axis."""
from repro_torch.distributed import pipeline
from repro_torch.distributed.mesh import (GridMesh, Mesh, PartitionSpec,
                                          all_gather, all_to_all,
                                          axis_devices, axis_size,
                                          card_groups, pmax, ppermute, psum,
                                          shard_shape)
from repro_torch.distributed.pipeline import StageGroups, place_stages

__all__ = ["Mesh", "GridMesh", "PartitionSpec", "axis_size", "axis_devices",
           "card_groups", "shard_shape", "psum", "pmax", "all_gather",
           "all_to_all", "ppermute", "pipeline", "place_stages",
           "StageGroups"]
