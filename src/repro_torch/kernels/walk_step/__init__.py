"""One-hop walk-step kernels (uniform and alias) for the ``cuda`` step."""
from repro_torch.kernels.walk_step.ops import (LAUNCHES, reset_launches,
                                               walk_step_alias,
                                               walk_step_uniform)

__all__ = ["walk_step_uniform", "walk_step_alias", "LAUNCHES",
           "reset_launches"]
