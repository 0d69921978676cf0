"""Hand-written CUDA kernels (built with nvcc on first use) and their plain
PyTorch versions."""
