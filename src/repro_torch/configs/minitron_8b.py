"""minitron-8b [arXiv:2407.14679]: 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000 — pruned nemotron."""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
FULL = TransformerConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=16384, vocab=256000,
)
SMOKE = TransformerConfig(
    name="minitron-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=200,
)
