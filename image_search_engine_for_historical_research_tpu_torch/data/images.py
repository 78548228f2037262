"""Image loading and padded-canvas batching (host side, numpy + PIL).

The port's own copy of part of
``image_search_engine_for_historical_research_tpu/data/images.py`` (:23-85,
:160-215): truncated-file-tolerant PIL loading, test-mode bbx crop +
thumbnail, ImageNet normalization, and ``bucket_batches``, which groups
variable-aspect images into canvases rounded up to multiples of 32 (the
backbone's stride) with validity masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
STRIDE = 32  # backbone total stride: canvas dims are rounded up to this


def pil_loader(path: str):
    """Truncated-image-tolerant RGB loader."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


def imthumbnail(img, imsize: float):
    """In-place thumbnail to max side <= imsize."""
    from PIL import Image

    resample = getattr(Image, "LANCZOS", None) or Image.Resampling.LANCZOS
    img.thumbnail((int(imsize), int(imsize)), resample)
    return img


def load_test_image(
    path: str,
    imsize: Optional[int] = 1024,
    bbx: Optional[Sequence[float]] = None,
    raw: bool = False,
) -> np.ndarray:
    """Test-mode pipeline: optional bbx crop, thumbnail (bbx mode scales
    relative to the full image size), normalize. Returns float32 HWC, or the
    uint8 HWC pixels with ``raw=True`` (for paths that normalize on the
    device)."""
    img = pil_loader(path)
    imfullsize = max(img.size)
    if bbx is not None:
        img = img.crop(tuple(bbx))
    if imsize is not None:
        if bbx is not None:
            imthumbnail(img, imsize * max(img.size) / imfullsize)
        else:
            imthumbnail(img, imsize)
    if raw:
        return np.asarray(img, np.uint8)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def _canvas_shape(h: int, w: int) -> Tuple[int, int]:
    rh = ((h + STRIDE - 1) // STRIDE) * STRIDE
    rw = ((w + STRIDE - 1) // STRIDE) * STRIDE
    return rh, rw


@dataclass
class Batch:
    """A padded canvas batch: images (B, H, W, 3), mask (B, H, W), source ids."""

    images: np.ndarray
    mask: np.ndarray
    indices: np.ndarray  # positions in the original list


def bucket_batches(
    arrays: Iterable[Tuple[int, np.ndarray]],
    batch_size: int = 16,
) -> Iterator[Batch]:
    """Group (index, HWC image) pairs by rounded canvas shape into batches,
    each zero-padded onto its canvas with a validity mask."""
    buckets = {}
    for idx, arr in arrays:
        shape = _canvas_shape(arr.shape[0], arr.shape[1])
        buckets.setdefault(shape, []).append((idx, arr))
        if len(buckets[shape]) >= batch_size:
            yield _pack(buckets.pop(shape), shape)
    for shape, items in buckets.items():
        yield _pack(items, shape)


def _pack(items, shape) -> Batch:
    H, W = shape
    B = len(items)
    images = np.zeros((B, H, W, 3), np.float32)
    mask = np.zeros((B, H, W), bool)
    indices = np.empty((B,), np.int64)
    for b, (idx, arr) in enumerate(items):
        h, w = arr.shape[:2]
        images[b, :h, :w] = arr
        mask[b, :h, :w] = True
        indices[b] = idx
    return Batch(images=images, mask=mask, indices=indices)


def iter_test_images(
    paths: Sequence[str],
    imsize: Optional[int] = 1024,
    bbxs: Optional[Sequence] = None,
) -> Iterator[Tuple[int, np.ndarray]]:
    for i, p in enumerate(paths):
        bbx = bbxs[i] if bbxs is not None else None
        yield i, load_test_image(p, imsize, bbx)
