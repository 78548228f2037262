"""Data stack: dataset configs, image loading/batching, the npz feature store
(whole and sharded), and synthetic fixture datasets (``data.synthetic``)."""

from .datasets import DATASETS, configdataset, query_bbxs, read_imlist
from .images import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Batch,
    bucket_batches,
    cid2filename,
    imresize,
    imthumbnail,
    iter_test_images,
    load_test_image,
    load_test_images_native,
    load_train_image,
    path_all_jpg,
    pil_loader,
)
from .store import (
    chunked_feature_relpaths,
    chunked_feature_source,
    feature_path,
    load_path_features,
    save_feature_shard,
    save_path_feature,
    shard_resume_point,
    shards_dir,
)

__all__ = [
    "DATASETS", "configdataset", "query_bbxs", "read_imlist",
    "IMAGENET_MEAN", "IMAGENET_STD", "Batch", "bucket_batches", "cid2filename",
    "imresize", "imthumbnail", "iter_test_images", "load_test_image",
    "load_test_images_native", "load_train_image", "path_all_jpg", "pil_loader",
    "feature_path", "load_path_features", "save_path_feature",
    "chunked_feature_relpaths", "chunked_feature_source", "save_feature_shard",
    "shard_resume_point", "shards_dir",
]
