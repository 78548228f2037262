"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

# one bottleneck per stage at full width: the stem, SOA4/SOA5 and the 2048-d
# head are the real ResNet101-SOLAR widths, at a fraction of the CPU time
ONE_BLOCK = "resnet_1111"


@contextlib.contextmanager
def one_block_arch():
    """Register ``ONE_BLOCK`` in both packages' architecture tables."""
    from image_search_engine_for_historical_research_tpu.models import resnet as jresnet
    from image_search_engine_for_historical_research_tpu.models import retrieval as jretrieval
    from image_search_engine_for_historical_research_tpu_torch.models import resnet as tresnet
    from image_search_engine_for_historical_research_tpu_torch.models import (
        retrieval as tretrieval,
    )

    with pytest.MonkeyPatch.context() as mp:
        for table in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(table, ONE_BLOCK, (1, 1, 1, 1))
        for table in (jretrieval.OUTPUT_DIM, tretrieval.OUTPUT_DIM):
            mp.setitem(table, ONE_BLOCK, 2048)
        yield


def perturbed_variables(variables, seed: int = 0):
    """Numpy copy of a Flax variable tree with every parameter and BN
    statistic moved by seeded noise: without it the SOA ``v`` conv is zero,
    SOA is the identity and attention is never tested."""
    rng = np.random.default_rng(seed)

    def perturb(a, leaf):
        noise = rng.standard_normal(a.shape)
        if leaf == "kernel":
            return a + 0.5 * noise / np.sqrt(np.prod(a.shape[:-1]))
        if leaf == "var":
            return a * np.exp(0.2 * noise)
        if leaf == "gem_p":
            return a + 0.25 * np.abs(noise)
        return a + 0.1 * noise                 # scale, bias, mean

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        return np.asarray(perturb(a, path[-1]), np.float32)

    return walk(variables, ())


def write_images(directory, n: int, seed: int, n_classes: int = 3):
    """``n`` JPEGs of two aspect ratios: a per-class smooth pattern plus a
    strong per-image pattern, so descriptors are distinct and scores do not
    nearly tie."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    bases = rng.uniform(0, 255, (n_classes, 6, 8, 3))
    paths = []
    for i in range(n):
        h, w = (72, 96) if i % 2 == 0 else (96, 72)
        base = np.asarray(
            Image.fromarray(bases[i % n_classes].astype(np.uint8)).resize((w, h), Image.BILINEAR),
            np.float32,
        )
        own = np.asarray(
            Image.fromarray(rng.uniform(0, 255, (4, 4, 3)).astype(np.uint8)).resize(
                (w, h), Image.BILINEAR
            ),
            np.float32,
        )
        arr = 0.6 * base + 0.4 * own + rng.normal(0, 8, (h, w, 3))
        p = os.path.join(directory, f"im{i:02d}.jpg")
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    return paths


def assert_same_beams(s_ref, i_ref, s_got, i_got, atol=1e-4, tie=1e-5):
    """Each row holds the same ids with the same scores (``atol``); where the
    order differs, the scores at those ranks are within ``tie``."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    assert i_ref.shape == i_got.shape
    for r in range(i_ref.shape[0]):
        assert sorted(i_ref[r].tolist()) == sorted(i_got[r].tolist()), r
        ref = dict(zip(i_ref[r].tolist(), s_ref[r].tolist()))
        for i, s in zip(i_got[r].tolist(), s_got[r].tolist()):
            assert abs(ref[i] - s) <= atol, (r, i, ref[i], s)
        moved = i_ref[r] != i_got[r]
        np.testing.assert_allclose(s_got[r][moved], s_ref[r][moved], rtol=0, atol=tie)
