"""Checkpoints: one directory per step, committed by an atomic rename."""
