"""Optimizers (AdamW with a warmup-cosine schedule) and the cross-pod
int8 gradient compression."""
from repro_torch.optim import adamw, grad_compression
