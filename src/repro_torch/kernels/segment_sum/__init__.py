"""The segment-sum kernel: a deterministic segmented reduction (the backward of
the SGNS step's row gathers)."""
from repro_torch.kernels.segment_sum.ops import (LAUNCHES, SegmentSumOp,
                                                 reset_launches, segment_sum)

__all__ = ["segment_sum", "SegmentSumOp", "LAUNCHES", "reset_launches"]
