"""Re-ranking: query expansion (qge1)."""

from .qe import feature_enhancement, qge1

__all__ = ["feature_enhancement", "qge1"]
