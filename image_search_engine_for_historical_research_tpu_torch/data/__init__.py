"""Data stack: dataset configs, image loading/batching, the npz feature store."""

from .datasets import DATASETS, configdataset, query_bbxs, read_imlist
from .images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Batch,
    bucket_batches,
    imthumbnail,
    iter_test_images,
    load_test_image,
    path_all_jpg,
    pil_loader,
)
from .store import feature_path, load_path_features, save_path_feature

__all__ = [
    "DATASETS", "configdataset", "query_bbxs", "read_imlist",
    "IMAGENET_MEAN", "IMAGENET_STD", "Batch", "bucket_batches", "imthumbnail",
    "iter_test_images", "load_test_image", "path_all_jpg", "pil_loader",
    "feature_path", "load_path_features", "save_path_feature",
]
