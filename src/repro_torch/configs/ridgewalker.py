"""The paper's walk workloads: GRW algorithms × graph datasets (Table II /
§VIII-A4)."""
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import EngineConfig

FAMILY = "walk"
ALGORITHMS = {
    "urw": SamplerSpec(kind="uniform"),
    "ppr": SamplerSpec(kind="uniform", stop_prob=0.15),
    "deepwalk": SamplerSpec(kind="alias"),
    "node2vec": SamplerSpec(kind="rejection_n2v", p=2.0, q=0.5),
    "node2vec_w": SamplerSpec(kind="reservoir_n2v", p=2.0, q=0.5),
}
QUERY_LENGTH = 80          # paper §VIII-A4
ENGINE = EngineConfig(num_slots=4096, max_hops=QUERY_LENGTH,
                      record_paths=False)
DATASETS = ("WG", "CP", "AS", "LJ", "AB", "UK")
