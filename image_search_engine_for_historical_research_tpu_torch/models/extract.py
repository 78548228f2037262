"""Descriptor extraction: multi-scale forward over masked, padded batches.

Port of ``image_search_engine_for_historical_research_tpu/models/extract.py``.
Resizes match ``jax.image.resize``: bilinear with antialiasing (it
antialiases when it downscales) for images, ``nearest-exact`` for the mask,
sizes ``int(H * s)``. ``make_sharded_extract_fn`` splits a batch over the
ranks of a ``parallel.data_mesh`` (one process a GPU). Each scale's forward
is the device span ``extract.scale_{s:.2f}`` (``utils.tracing``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.normalization import l2n
from ..utils import tracing

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
        with tracing.span(f"extract.scale_{s:.2f}", device=images.device):
            v = module(xs, ms).float()    # (B, D), already l2n'd
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


def make_sharded_extract_fn(module, mesh, scales: Sequence[float] = DEFAULT_SCALES,
                            axis: str = "data"):
    """``make_extract_fn`` with the batch split over ``mesh``'s ``axis``:
    every rank calls ``fn(images, mask)`` on the same whole batch (a tensor
    or a ``parallel.shard_batch`` result), runs its own block of rows and
    gets back the whole ``(B, D)`` f32 result, in row order (an
    all-gather). A batch whose rows do not divide the mesh raises
    ``ValueError``; pad it (``extract_vectors(pad_batches=True)``)."""
    from ..parallel.mesh import gather_rows, local_rows, mesh_size

    mesh_size(mesh, axis)
    scales = tuple(scales)

    def fn(images: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x, _ = local_rows(images, mesh, axis)
        m = None if mask is None else local_rows(mask, mesh, axis)[0]
        with torch.inference_mode():
            v = multiscale_descriptor(module, x, m, scales=scales).float()
            return gather_rows(v, mesh, axis)

    return fn


def extract_vectors(
    model,
    paths,
    image_size: int = 1024,
    bbxs=None,
    scales: Sequence[float] = (1.0,),
    batch_size: int = 16,
    extract_fn=None,
    pad_batches: bool = False,
    loader: str = "pil",
) -> np.ndarray:
    """Paths -> ``(N, D)`` f32 descriptors: test-mode load (bbx crop +
    thumbnail), bucket into padded canvas batches with masks, run the
    multi-scale extraction on ``model``'s device per batch.

    ``extract_fn``: a ``make_extract_fn`` function to run instead of a fresh
    one (the trainer's mining and ``cli.extract_1m`` build theirs once).
    ``pad_batches`` fills a short batch up to ``batch_size`` with all-masked
    zero canvases, whose rows are dropped (a sharded ``extract_fn`` needs
    rows that divide the mesh; every operation of the model works on one
    row, so the padding touches no real row).
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
        images, mask = batch.images, batch.mask
        n_real = images.shape[0]
        if pad_batches and n_real < batch_size:
            pad = batch_size - n_real
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
        vecs = fn(torch.from_numpy(images).to(device), torch.from_numpy(mask).to(device))
        out[batch.indices] = vecs[:n_real].cpu().numpy()
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
