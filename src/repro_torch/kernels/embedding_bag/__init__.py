"""The embedding-bag kernel: weighted sums of gathered table rows (the
SGNS step's row gathers, one-row bags)."""
from repro_torch.kernels.embedding_bag.ops import (LAUNCHES, embedding_bag,
                                                   reset_launches)

__all__ = ["embedding_bag", "LAUNCHES", "reset_launches"]
