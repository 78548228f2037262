"""Seeds: every draw of a run comes from ``--seed`` and a tag."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream named ``tag`` of run seed ``seed`` (any
    non-negative whole number, also one wider than 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, tag: str, device="cpu"):
    import torch

    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))
