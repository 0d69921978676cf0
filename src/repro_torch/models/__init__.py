"""Model zoo: skip-gram embeddings (the walk corpus's trainer), GNNs
(SchNet, PNA, MeshGraphNet, MACE) and recsys (DCN-v2)."""
