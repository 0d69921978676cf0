"""Graph substrate: CSR representation, generators, alias tables, datasets,
partitioning."""
from repro_torch.graph.alias import build_alias_tables
from repro_torch.graph.csr import (CSRGraph, build_csr, degrees,
                                   from_reference_arrays, validate_csr)
from repro_torch.graph.datasets import (DATASET_SPECS, make_cora_like,
                                        make_dataset)
from repro_torch.graph.generators import (BALANCED, GRAPH500,
                                         erdos_renyi_edges, rmat_edges)
from repro_torch.graph.hot_cache import (HotVertexCache, build_hot_cache,
                                         edge_payload_bytes,
                                         vertex_overhead_bytes)
from repro_torch.graph.partition import (PartitionedGraph, owner_of,
                                         partition_graph)

__all__ = [
    "CSRGraph", "build_csr", "degrees", "validate_csr",
    "from_reference_arrays",
    "rmat_edges", "erdos_renyi_edges", "GRAPH500", "BALANCED",
    "build_alias_tables", "make_dataset", "make_cora_like", "DATASET_SPECS",
    "HotVertexCache", "build_hot_cache", "edge_payload_bytes",
    "vertex_overhead_bytes",
    "partition_graph", "PartitionedGraph", "owner_of",
]
