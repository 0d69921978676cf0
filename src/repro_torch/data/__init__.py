"""Deterministic synthetic data pipelines."""
from repro_torch.data import pipeline
