"""meshgraphnet [arXiv:2010.03409]: 15L d_hidden=128 sum agg, 2-layer MLPs."""
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn.meshgraphnet import MeshGraphNetConfig

FAMILY = "gnn"
SHAPES = GNN_SHAPES
FULL = MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2)
SMOKE = MeshGraphNetConfig(n_layers=3, d_hidden=32, mlp_layers=2,
                           node_in=8, edge_in=4)
