"""Seeded scene photographs, made on the device and encoded as JPEGs.

A rewrite of the port's ``data/synthetic.py`` scene generator
(``_scene_canvas`` and ``_scene_view``): each scene is a multi-octave smooth
random canvas with the same colour and noise statistics as every other, so
identity lies in the spatial pattern alone; a photograph is a crop of its
scene's canvas, flipped at random, with a gain, an offset and pixel noise.
Overlapping crops of one canvas stand for views of one landmark. Here the
canvases and views are drawn on the device in a few calls, a finer octave
gives texture at the matchers' 1/8 resolution, and every photograph of a
pool has one of the given sizes, in equal shares.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .seeds import generator, rng

OCTAVES = (6, 24, 96)
AMPLITUDES = (72.0, 36.0, 18.0)


@dataclass
class Pool:
    jpegs: List[bytes]            # encoded photographs
    scene: np.ndarray             # (n,) scene of each photograph
    hw: np.ndarray                # (n, 2) height, width


def scene_canvases(seed: int, n_scenes: int, side: int, device) -> torch.Tensor:
    """``(n_scenes, 3, side, side)`` f32 canvases in [0, 255]."""
    g = generator(seed, "photos.scenes", device)
    canvas = torch.full((n_scenes, 3, side, side), 128.0, device=device)
    for o, amp in zip(OCTAVES, AMPLITUDES):
        low = torch.randn(n_scenes, 3, o, o, generator=g, device=device)
        canvas += amp * F.interpolate(low, size=(side, side), mode="bilinear",
                                      align_corners=False)
    return canvas.clamp_(0, 255)


def photographs(seed: int, n: int, n_scenes: int, sizes_hw: Sequence[Tuple[int, int]],
                device, noise: float = 6.0) -> Tuple[List[np.ndarray], np.ndarray]:
    """``n`` uint8 HWC photographs: photograph ``i`` shows scene ``i %
    n_scenes`` at size ``sizes_hw[i % len(sizes_hw)]``."""
    side = int(max(max(h, w) for h, w in sizes_hw) * 1.25)
    canvases = scene_canvases(seed, n_scenes, side, device)
    r = rng(seed, "photos.views")
    g = generator(seed, "photos.noise", device)
    out, scenes = [], np.arange(n) % n_scenes
    for i in range(n):
        h, w = sizes_hw[i % len(sizes_hw)]
        y, x = int(r.integers(0, side - h + 1)), int(r.integers(0, side - w + 1))
        view = canvases[scenes[i], :, y:y + h, x:x + w]
        if r.random() < 0.5:
            view = view.flip(2)
        view = view * float(r.uniform(0.8, 1.2)) + float(r.uniform(-12, 12))
        view = view + noise * torch.randn(view.shape, generator=g, device=device)
        out.append(view.clamp(0, 255).round().to(torch.uint8).permute(1, 2, 0))
    del canvases
    return [v.cpu().numpy() for v in out], scenes


def encode_jpegs(images: Sequence[np.ndarray], quality: int, threads: int = 8) -> List[bytes]:
    from PIL import Image

    def enc(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", quality=quality)
        return buf.getvalue()

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(enc, images))


def make_pool(seed: int, n: int, n_scenes: int, sizes_hw, quality: int, device) -> Pool:
    images, scenes = photographs(seed, n, n_scenes, [tuple(s) for s in sizes_hw], device)
    hw = np.array([a.shape[:2] for a in images], np.int64)
    return Pool(encode_jpegs(images, quality), scenes, hw)


def write_pool(jpegs: Sequence[bytes], directory: str, prefix: str = "photo") -> List[str]:
    import os

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, data in enumerate(jpegs):
        p = os.path.join(directory, f"{prefix}_{i:04d}.jpg")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    return paths
