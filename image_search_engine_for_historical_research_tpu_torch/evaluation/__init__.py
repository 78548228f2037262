"""Evaluation protocols: revisited mAP, custom/GLM protocols, label mAP."""

from .map import (
    RevisitedResult,
    cal_map_labels,
    compute_ap,
    compute_map,
    compute_map_and_print,
    compute_map_revisited,
    map_custom,
    map_glm,
)

__all__ = [
    "RevisitedResult",
    "cal_map_labels",
    "compute_ap",
    "compute_map",
    "compute_map_and_print",
    "compute_map_revisited",
    "map_custom",
    "map_glm",
]
