"""The shard axis of the sharded backend and its collectives."""
from repro_torch.distributed.mesh import Mesh, all_gather, all_to_all, psum

__all__ = ["Mesh", "psum", "all_gather", "all_to_all"]
