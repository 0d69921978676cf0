"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family]:
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8.

Experts (40) don't divide the 16-way model axis -> expert-FFN hidden
sharding (TP over d_ff), see models/moe.py."""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
FULL = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512, expert_sharding="ffn"),
)
SMOKE = TransformerConfig(
    name="granite-moe-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=111,
    moe=MoEConfig(num_experts=5, top_k=3, d_ff=32, expert_sharding="ffn"),
)
