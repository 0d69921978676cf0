"""Recommendation models: the embedding substrate and DCN-v2."""
from repro_torch.models.recsys import dcn, embedding
