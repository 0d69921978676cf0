"""mace [arXiv:2206.07697]: 2L d_hidden=128 l_max=2 correlation=3 n_rbf=8,
E(3)-equivariant (Cartesian irreps, see models/gnn/mace.py)."""
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn.mace import MACEConfig

FAMILY = "gnn"
SHAPES = GNN_SHAPES
FULL = MACEConfig(n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8)
SMOKE = MACEConfig(n_layers=2, d_hidden=8, l_max=2, correlation=3, n_rbf=4)
