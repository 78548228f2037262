"""Image loading and padded-canvas batching (host side, numpy + PIL).

The port's own copy of
``image_search_engine_for_historical_research_tpu/data/images.py`` (all of
it): truncated-file-tolerant PIL loading, test-mode bbx
crop + thumbnail, ImageNet normalization, the batch decode through the
native threaded JPEG loader (``load_test_images_native``), the train-mode
short-side resize + random square crop (``load_train_image``),
``bucket_batches``, which groups variable-aspect images into canvases rounded
up to multiples of 32 (the backbone's stride) with validity masks, the
recursive jpg listing ``path_all_jpg``, the SfM120k hashed path
``cid2filename``, ``unnormalize`` and the rank contact sheet
``save_rank_montage``.
"""

from __future__ import annotations

import os
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


def imresize(img, imsize: int):
    """Resize so the short side is ``imsize`` (torchvision ``Resize``
    semantics), bilinear."""
    from PIL import Image

    w, h = img.size
    if w < h:
        nw, nh = imsize, int(round(imsize * h / w))
    else:
        nw, nh = int(round(imsize * w / h)), imsize
    resample = getattr(Image, "BILINEAR", None) or Image.Resampling.BILINEAR
    return img.resize((int(nw), int(nh)), resample)


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


def load_test_images_native(
    paths: Sequence[str],
    imsize: Optional[int] = 1024,
    threads: int = 8,
    raw: bool = False,
) -> list:
    """Test-mode loading of a batch through the native threaded JPEG decoder
    (``native/image_loader.cpp``: libjpeg with DCT prescaling + box-filter
    thumbnail, one thread pool for the whole batch).

    The semantics are ``load_test_image(path, imsize)``'s without a bbx:
    only-shrink thumbnail to max side ``imsize``, ImageNet-normalized f32 HWC
    (uint8 with ``raw=True``). Pixels differ from PIL's at the filter level
    only (box against Lanczos). A file the decoder rejects (not a JPEG,
    truncated) is loaded by PIL, image by image: the reference's
    truncated-file tolerance. A failed build of the library raises."""
    import ctypes

    from ..native import load

    n = len(paths)
    if n == 0:
        return []
    if imsize is None:
        # the decoder needs a fixed canvas side; full resolution keeps PIL's
        # semantics exactly, image by image
        return [load_test_image(p, None, raw=raw) for p in paths]
    lib = load("image_loader")
    decode = lib.decode_thumbnail_batch
    decode.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int]
    decode.restype = None
    s = int(imsize)
    out = np.empty((n, s, s, 3), np.float32)   # the decoder zeroes the canvas itself
    hw = np.zeros((n, 2), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    decode(arr, n, s, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(threads))
    images = []
    for i in range(n):
        h, w = int(hw[i, 0]), int(hw[i, 1])
        if h == 0 or w == 0:                       # rejected by the decoder
            images.append(load_test_image(paths[i], imsize, raw=raw))
            continue
        img = out[i, :h, :w]
        if raw:
            # the decoder wrote px / 255: back to uint8 (exact for decoded
            # values; the box filter's averages round by <= 0.5 / 255)
            images.append((img * 255.0 + 0.5).astype(np.uint8))
            continue
        images.append((img - IMAGENET_MEAN) / IMAGENET_STD)
    return images


def load_train_image(path: str, imsize: int, rng: np.random.Generator) -> np.ndarray:
    """Train-mode pipeline: short-side resize to ``imsize``, then a random
    ``imsize`` x ``imsize`` crop (offsets drawn from ``rng``), normalized."""
    img = imresize(pil_loader(path), imsize)
    w, h = img.size
    x0 = int(rng.integers(0, max(w - imsize, 0) + 1))
    y0 = int(rng.integers(0, max(h - imsize, 0) + 1))
    img = img.crop((x0, y0, x0 + imsize, y0 + imsize))
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


def path_all_jpg(directory: str, start: Optional[str] = None):
    """Recursive sorted ``.jpg`` listing and the paths relative to ``start``
    (default ``directory``)."""
    paths = []
    for dirpath, _, filenames in os.walk(directory):
        paths += [os.path.join(dirpath, f) for f in filenames if f.endswith(".jpg")]
    paths.sort()
    rel = [os.path.relpath(p, start or directory) for p in paths]
    return paths, rel


def cid2filename(cid: str, prefix: str) -> str:
    """SfM120k image id -> its 3-level hashed path under ``prefix``."""
    return os.path.join(prefix, cid[-2:], cid[-4:-2], cid[-6:-4], cid)


def unnormalize(rgb: np.ndarray) -> np.ndarray:
    """Reverse ImageNet normalization to [0, 1]; NHWC layout."""
    out = rgb * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(out, 0.0, 1.0)


def save_rank_montage(
    query_path: str,
    db_paths: Sequence[str],
    ranks_row: np.ndarray,
    out_path: str,
    k: int = 10,
    thumb: int = 128,
):
    """Write a horizontal query-plus-top-k contact sheet (the reference's
    test_custom rank visualisation)."""
    from PIL import Image

    tiles = [query_path] + [db_paths[int(i)] for i in ranks_row[:k]]
    canvas = Image.new("RGB", (thumb * len(tiles), thumb), (30, 30, 30))
    for i, p in enumerate(tiles):
        im = pil_loader(p)
        im.thumbnail((thumb, thumb))
        canvas.paste(im, (i * thumb + (thumb - im.size[0]) // 2,
                          (thumb - im.size[1]) // 2))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    canvas.save(out_path)
    return out_path
