"""Models trained on the walk corpus (skip-gram with negative sampling)."""
