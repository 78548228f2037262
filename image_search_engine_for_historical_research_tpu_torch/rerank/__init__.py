"""Re-ranking: query expansion, kNN-graph diffusion, k-reciprocal."""

from .qe import (
    average_query_expansion,
    database_augmentation,
    feature_enhancement,
    qge1,
)
from .diffusion import (
    DiffusionOffline,
    build_diffusion_offline,
    diffusion_online_scores,
    diffusion_rerank,
)
from .kr import kr_rerank, kr_rerank_chunked, kr_rerank_scores

__all__ = [
    "average_query_expansion", "database_augmentation", "feature_enhancement", "qge1",
    "DiffusionOffline", "build_diffusion_offline", "diffusion_online_scores",
    "diffusion_rerank",
    "kr_rerank", "kr_rerank_chunked", "kr_rerank_scores",
]
