"""The paper's walk workloads: GRW algorithms × graph datasets (Table II /
§VIII-A4), for the algorithms this package runs."""
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import EngineConfig

ALGORITHMS = {
    "urw": SamplerSpec(kind="uniform"),
    "ppr": SamplerSpec(kind="uniform", stop_prob=0.15),
    "deepwalk": SamplerSpec(kind="alias"),
}
QUERY_LENGTH = 80          # paper §VIII-A4
ENGINE = EngineConfig(num_slots=4096, max_hops=QUERY_LENGTH,
                      record_paths=False)
