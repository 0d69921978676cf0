"""The fused superstep kernel (``step_impl="fused"``): k whole supersteps
of the walk engine per launch, on the device."""
from repro_torch.kernels.fused_superstep.ops import (LAUNCHES, fused_superstep,
                                                     reset_launches)

__all__ = ["fused_superstep", "LAUNCHES", "reset_launches"]
