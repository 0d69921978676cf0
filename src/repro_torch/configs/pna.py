"""pna [arXiv:2004.05718]: 4L d_hidden=75, mean/max/min/std aggregators,
identity/amplification/attenuation scalers."""
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn.pna import PNAConfig

FAMILY = "gnn"
SHAPES = GNN_SHAPES
FULL = PNAConfig(n_layers=4, d_hidden=75)
SMOKE = PNAConfig(n_layers=2, d_hidden=16, node_in=8, out_dim=5)
