"""Hand-written CUDA kernels (built with nvcc on first use) and their plain
PyTorch versions.  Importing them builds nothing: a library is built and
loaded at the first launch on a CUDA tensor (`repro_torch.kernels.build`)."""
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.segment_sum import SegmentSumOp, segment_sum
from repro_torch.kernels.walk_step import walk_step_alias, walk_step_uniform

__all__ = ["embedding_bag", "segment_sum", "SegmentSumOp",
           "walk_step_uniform", "walk_step_alias"]
