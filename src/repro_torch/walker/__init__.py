"""Walker API: one declarative program, compiled for a backend.

``WalkProgram`` (algorithm: sampler + termination + hop budget) ×
``ExecutionConfig`` (machine: slots, staging, step implementation, shards)
→ ``compile(program, backend=...)`` → a ``Walker`` whose ``.run(graph,
starts)`` drains a closed batch on the graph's device, ``.stream(graph)``
keeps an open system and ``.serve(graph)`` puts a request service on it,
on ``backend="single"`` or ``"sharded"`` (N shards stacked on the graph's
device, bit-identical to the single backend; ``.stream`` is a
``WalkStream`` or ``ShardedWalkStream`` with one shared interface).
"""
from repro_torch.walker.compile import (BACKENDS, ShardedWalkStream, Walker,
                                        WalkStream, compile)
from repro_torch.walker.execution import ExecutionConfig
from repro_torch.walker.program import WalkProgram

__all__ = ["WalkProgram", "ExecutionConfig", "compile", "Walker",
           "WalkStream", "ShardedWalkStream", "BACKENDS"]
