"""Data stack: image loading/batching and the npz feature store."""

from .images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Batch,
    bucket_batches,
    imthumbnail,
    iter_test_images,
    load_test_image,
    pil_loader,
)
from .store import feature_path, load_path_features, save_path_feature

__all__ = [
    "IMAGENET_MEAN", "IMAGENET_STD", "Batch", "bucket_batches", "imthumbnail",
    "iter_test_images", "load_test_image", "pil_loader",
    "feature_path", "load_path_features", "save_path_feature",
]
