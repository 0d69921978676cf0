"""The shard axis of the sharded backend and its collectives; the GPipe
schedule over a stacked ``pipe`` axis."""
from repro_torch.distributed import pipeline
from repro_torch.distributed.mesh import (GridMesh, Mesh, all_gather,
                                          all_to_all, axis_size, pmax, psum)

__all__ = ["Mesh", "GridMesh", "axis_size", "psum", "pmax", "all_gather",
           "all_to_all", "pipeline"]
