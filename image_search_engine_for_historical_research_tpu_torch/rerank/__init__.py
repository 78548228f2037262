"""Re-ranking: query expansion, kNN-graph diffusion, k-reciprocal, and
local-feature geometric verification (SIFT + AdaLAM, LoFTR)."""

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
from .adalam import DEFAULT_CONFIG as ADALAM_DEFAULT_CONFIG, AdalamFilter
from .kr import kr_rerank, kr_rerank_chunked, kr_rerank_scores
from .geometric import (
    LocalFeatures,
    loftr_rerank,
    make_adalam_verifier,
    make_verifier,
    rerank_by_inliers,
    sift_extract,
    sift_extract_device,
    sift_offline,
    sift_rerank,
)

__all__ = [
    "average_query_expansion", "database_augmentation", "feature_enhancement", "qge1",
    "DiffusionOffline", "build_diffusion_offline", "diffusion_online_scores",
    "diffusion_rerank",
    "ADALAM_DEFAULT_CONFIG", "AdalamFilter",
    "kr_rerank", "kr_rerank_chunked", "kr_rerank_scores",
    "LocalFeatures", "loftr_rerank", "make_adalam_verifier", "make_verifier", "rerank_by_inliers",
    "sift_extract", "sift_extract_device", "sift_offline", "sift_rerank",
]
