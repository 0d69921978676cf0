"""schnet [arXiv:1706.08566]: 3 interactions d_hidden=64 rbf=300 cutoff=10."""
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn.schnet import SchNetConfig

FAMILY = "gnn"
SHAPES = GNN_SHAPES
FULL = SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
SMOKE = SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=24, cutoff=10.0)
