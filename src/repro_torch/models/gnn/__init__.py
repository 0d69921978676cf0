"""Graph neural networks: SchNet, PNA, MeshGraphNet, MACE."""
from repro_torch.models.gnn import mace, meshgraphnet, pna, schnet
