"""Measurement-driven autotuner with roofline-model search-space pruning.

The engine's realized throughput hangs on machine knobs —
``num_slots``, ``hops_per_launch``, ``queue_depth_factor``, the
hot-vertex cache budget, the E-S reservoir chunking — whose right values
are a function of *(graph, sampler, machine, workload)*, not constants.
This package closes that loop:

* `repro_torch.tune.space` — the tunable knob grid + validity
  constraints (delegated to the config dataclasses' own validation);
* `repro_torch.tune.model` — the analytical cost model (bytes/hop
  counted off the fused CUDA kernel's loads) used to prune the grid and
  to answer ``"auto"`` sentinels without timing;
* `repro_torch.tune.measure` — the **only** module allowed to read a
  clock (interleaved min-of-k timing; tests inject deterministic costs);
* `repro_torch.tune.cache` — the persistent JSON cache keyed by graph
  signature x sampler x machine (the graph's device) x workload;
* `repro_torch.tune.tuner` — orchestration: `autotune` (measured) and
  `resolve` (cache/model-only; what ``Walker`` binding calls).

CLI: ``python -m repro_torch.tune [--no-measure] [--device cpu] --cache
tune_cache.json``.
"""
from repro_torch.tune.cache import (GraphSignature, TuningCache, cache_key,
                                    default_cache_path, graph_signature,
                                    workload_bucket)
from repro_torch.tune.measure import InjectedMeasurer, Measurer, WalkMeasurer
from repro_torch.tune.model import (DEFAULT_COEFFS, CostCoeffs,
                                    adaptive_chunk_gate, bytes_per_hop,
                                    expected_walk_len, fit, live_max_degree,
                                    predict_us, prune)
from repro_torch.tune.space import (Candidate, Knob, default_candidate,
                                    enumerate_candidates, knobs_for)
from repro_torch.tune.tuner import (TuneResult, autotune, needs_resolution,
                                    resolve)

__all__ = [
    "GraphSignature", "TuningCache", "cache_key", "default_cache_path",
    "graph_signature", "workload_bucket",
    "Measurer", "InjectedMeasurer", "WalkMeasurer",
    "CostCoeffs", "DEFAULT_COEFFS", "adaptive_chunk_gate", "bytes_per_hop",
    "expected_walk_len", "fit", "live_max_degree", "predict_us", "prune",
    "Candidate", "Knob", "default_candidate", "enumerate_candidates",
    "knobs_for",
    "TuneResult", "autotune", "needs_resolution", "resolve",
]
