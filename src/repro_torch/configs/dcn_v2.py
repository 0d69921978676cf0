"""dcn-v2 [arXiv:2008.13535]: n_dense=13 n_sparse=26 embed_dim=16
3 cross layers, MLP 1024-1024-512, cross interaction."""
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.models.recsys.dcn import DCNConfig

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
FULL = DCNConfig()
SMOKE = DCNConfig(mlp_dims=(64, 32), vocab_sizes=tuple([500] * 26))
