"""Optimizers (AdamW with a warmup-cosine schedule)."""
from repro_torch.optim import adamw
