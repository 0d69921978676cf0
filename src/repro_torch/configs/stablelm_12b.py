"""stablelm-12b [hf:stabilityai/stablelm family]: 40L d_model=5120 32H
(GQA kv=8) d_ff=13824 vocab=100352."""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
FULL = TransformerConfig(
    name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
    n_kv_heads=8, d_ff=13824, vocab=100352,
)
SMOKE = TransformerConfig(
    name="stablelm-smoke", n_layers=2, d_model=80, n_heads=4, n_kv_heads=2,
    d_ff=216, vocab=157,
)
