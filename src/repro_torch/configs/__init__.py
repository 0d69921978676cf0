"""Architecture registry: ``--arch <id>`` resolves here.

The reference's ten archs in its order: the five language models and the
graph-learning zoo (GNN and recsys families).  ``get_arch("ridgewalker")``
gives the walk workloads, as in the reference.
"""
import importlib

ARCHS = (
    "phi35_moe", "granite_moe", "deepseek_7b", "minitron_8b", "stablelm_12b",
    "meshgraphnet", "schnet", "pna", "mace", "dcn_v2",
)

ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-3b-a800m": "granite_moe",
    "deepseek-7b": "deepseek_7b",
    "minitron-8b": "minitron_8b",
    "stablelm-12b": "stablelm_12b",
    "dcn-v2": "dcn_v2",
}


def get_arch(name: str):
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in ARCHS and name != "ridgewalker":
        raise ValueError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")
