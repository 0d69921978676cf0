"""Architecture registry: ``--arch <id>`` resolves here.

The port holds the graph-learning half of the reference's zoo: the GNN
and recsys families.  The reference's five language models come with the
next slice (ROADMAP item 11b); asking for one raises ``ValueError``.
``get_arch("ridgewalker")`` gives the walk workloads, as in the reference.
"""
import importlib

ARCHS = ("meshgraphnet", "schnet", "pna", "mace", "dcn_v2")

#: The reference's language-model archs, not ported yet (ROADMAP item 11b).
LM_ARCHS = ("phi35_moe", "granite_moe", "deepseek_7b", "minitron_8b",
            "stablelm_12b")

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
    if name in LM_ARCHS:
        raise ValueError(
            f"arch {name!r} is a language model; the port's language-model "
            f"family is not ported yet (ROADMAP item 11b, the LM slice of "
            f"item 11)")
    if name not in ARCHS and name != "ridgewalker":
        raise ValueError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")
