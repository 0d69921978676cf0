"""Checkpoints: one directory per step, committed by an atomic rename."""
from repro_torch.checkpoint import checkpointer
