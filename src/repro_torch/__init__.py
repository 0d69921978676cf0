"""RidgeWalker graph random walks in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The package mirrors ``repro`` (the JAX reference) module for module and
name for name, and is held bit-equal to it in paths, lengths and every
``WalkStats`` field.  Entry point: ``repro_torch.walker.compile(program)
.run(graph, starts)``.  Graphs are built on ``"cuda"`` unless the caller
asks for ``device="cpu"``.
"""
