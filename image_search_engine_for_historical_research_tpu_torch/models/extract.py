"""Descriptor extraction: multi-scale forward over masked, padded batches.

Port of ``image_search_engine_for_historical_research_tpu/models/extract.py``
(:24-113, :153-231). Resizes match ``jax.image.resize``: bilinear with
antialiasing (it antialiases when it downscales) for images, ``nearest-exact``
for the mask, sizes ``int(H * s)``. The sharded extract function is not
ported yet (multi-GPU, ROADMAP section 1, item 5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.normalization import l2n

DEFAULT_SCALES = (1.0, 2 ** 0.5, 0.5 ** 0.5)


def _resize_images(images: torch.Tensor, scale: float) -> torch.Tensor:
    """NHWC bilinear resize by ``scale`` (floor-sized)."""
    B, H, W, C = images.shape
    size = (int(H * scale), int(W * scale))
    x = F.interpolate(images.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _resize_mask(mask: torch.Tensor, scale: float) -> torch.Tensor:
    B, H, W = mask.shape
    size = (int(H * scale), int(W * scale))
    m = F.interpolate(mask[:, None].float(), size=size, mode="nearest-exact")
    return m[:, 0] > 0.5


def multiscale_descriptor(
    module,
    images: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scales: Sequence[float] = DEFAULT_SCALES,
) -> torch.Tensor:
    """``v = mean_s net(resize(x, s))``, L2-normalized by the exact norm (the
    JAX version with its ``msp`` left at 1, the value every caller uses).
    Resizes run in f32; a backbone built with ``compute_dtype`` casts each
    scale's input after the resize."""
    acc = None
    for s in scales:
        xs = images if s == 1.0 else _resize_images(images, s)
        ms = None
        if mask is not None:
            ms = mask if s == 1.0 else _resize_mask(mask, s)
        v = module(xs, ms).float()        # (B, D), already l2n'd
        acc = v if acc is None else acc + v
    return l2n(acc / len(scales), eps=0.0)


def make_extract_fn(module, scales: Sequence[float] = DEFAULT_SCALES):
    """``(images, mask) -> (B, D)`` f32 extraction function, run without
    autograd (the JAX version's ``(variables, images, mask)`` without the
    variables: the module holds its weights, and its ``compute_dtype``)."""
    scales = tuple(scales)

    def fn(images: torch.Tensor, mask: Optional[torch.Tensor] = None):
        with torch.inference_mode():
            v = multiscale_descriptor(module, images, mask, scales=scales)
        return v.float()

    return fn


def extract_vectors(
    model,
    paths,
    image_size: int = 1024,
    bbxs=None,
    scales: Sequence[float] = (1.0,),
    batch_size: int = 16,
    extract_fn=None,
    loader: str = "pil",
) -> np.ndarray:
    """Paths -> ``(N, D)`` f32 descriptors: test-mode load (bbx crop +
    thumbnail), bucket into padded canvas batches with masks, run the
    multi-scale extraction on ``model``'s device per batch.

    ``extract_fn``: a ``make_extract_fn`` function to run instead of a fresh
    one (the trainer's mining and ``cli.extract_1m`` build theirs once).
    ``loader="native"`` decodes each chunk of ``4 * batch_size`` paths
    through the threaded libjpeg loader (``data.load_test_images_native``);
    bbx crops always go through PIL (the crop needs the full-resolution
    image)."""
    from ..data.images import bucket_batches, iter_test_images

    if loader not in ("pil", "native"):
        raise ValueError(f"unknown loader: {loader!r}")
    if loader == "native" and bbxs is None:
        from ..data.images import load_test_images_native

        def native_source():
            chunk = 4 * batch_size
            for start in range(0, len(paths), chunk):
                arrays = load_test_images_native(paths[start:start + chunk], image_size)
                for j, arr in enumerate(arrays):
                    yield start + j, arr

        source = native_source()
    else:
        source = iter_test_images(paths, imsize=image_size, bbxs=bbxs)

    device = model.device
    fn = extract_fn or make_extract_fn(model.module, scales=scales)
    out = np.zeros((len(paths), model.outputdim), np.float32)
    for batch in bucket_batches(source, batch_size):
        vecs = fn(torch.from_numpy(batch.images).to(device),
                  torch.from_numpy(batch.mask).to(device))
        out[batch.indices] = vecs.cpu().numpy()
    return out


def extract_vectors_single(
    model,
    image_path: str,
    image_size: int = 1024,
    bbx=None,
    scales: Sequence[float] = (1.0,),
    extract_fn=None,
) -> np.ndarray:
    """One-query extraction; ``(D,)`` output."""
    return extract_vectors(
        model, [image_path], image_size, [bbx] if bbx is not None else None,
        scales, batch_size=1, extract_fn=extract_fn,
    )[0]
