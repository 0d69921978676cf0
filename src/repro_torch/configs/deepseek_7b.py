"""deepseek-7b [arXiv:2401.02954]: 30L d_model=4096 32H (MHA, kv=32)
d_ff=11008 vocab=102400 — llama-arch."""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES
FULL = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab=102400,
)
SMOKE = TransformerConfig(
    name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=172, vocab=160,
)
