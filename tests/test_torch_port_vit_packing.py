"""The ViT's packed key tokens (``models/vit.py``: ``pack_keys`` before the
blocks): what length the attention sees, whether it takes a mask, and that
the descriptors stay the benchmark's plain reference's (each upload alone
over its valid tokens), on the small seeded ViT of
``test_torch_port_vit.py``; and the counters a traced forward adds."""

import pytest
import torch

from image_search_engine_for_historical_research_tpu_torch.models import vit
from image_search_engine_for_historical_research_tpu_torch.models.extract import (
    _resize_images,
    _resize_mask,
    multiscale_descriptor,
)
from image_search_engine_for_historical_research_tpu_torch.utils import tracing
from test_torch_port_vit import CFG, REF, SCALES, SIDE, TOL, _gap, small  # noqa: F401
from torch_port_helpers import one_torch_thread  # noqa: F401

SPECIAL = 1 + CFG["num_register_tokens"]
GRID = SIDE // CFG["patch_size"]


def canvas(hws, seed=5):
    """Uploads of the given ``(h, w)`` at the top left of one square canvas,
    random junk in the padded region, and their masks (``(0, 0)``: an
    all-masked row, as ``extract_vectors(pad_batches=True)`` adds)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(len(hws), SIDE, SIDE, 3, generator=g)
    mask = torch.zeros(len(hws), SIDE, SIDE, dtype=torch.bool)
    for b, (h, w) in enumerate(hws):
        mask[b, :h, :w] = True
    return x, mask


def keys(h, w):
    """Key tokens of an upload at scale 1: the special tokens and the patches
    whose top-left pixel lies in it."""
    p = CFG["patch_size"]
    return SPECIAL + (-(-h // p)) * (-(-w // p))


def mask_keys(mask):
    """Each row's key tokens, read off its (resized) mask as ``embed`` reads
    them."""
    p = CFG["patch_size"]
    gh, gw = mask.shape[1] // p, mask.shape[2] // p
    return (SPECIAL + mask[:, :gh * p:p, :gw * p:p].sum((1, 2))).tolist()


EQUAL = [(SIDE, 84), (84, SIDE)]          # portrait and landscape, 48 patches each
UNEQUAL = [(SIDE, 70), (47, SIDE)]        # 40 and 32 patches


@pytest.fixture
def seen(monkeypatch):
    """Each attention core's ``(N, keep)``."""
    calls = []
    real = vit.attention_core

    def spy(q, k, v, keep):
        calls.append((q.shape[2], None if keep is None else keep.clone()))
        return real(q, k, v, keep)

    monkeypatch.setattr(vit, "attention_core", spy)
    return calls


def _reference(sd, x, mask, scale):
    if scale == "all":
        return torch.stack([REF.descriptor_of(sd, x[b], mask[b], CFG) for b in range(len(x))])
    return torch.stack([REF.net(sd, x[b], mask[b], CFG) for b in range(len(x))])


def _ours(m, x, mask, scale):
    if scale == "all":
        return multiscale_descriptor(m, x, mask, SCALES)
    return m(x, mask)


def _at(x, mask, scale):
    if scale in (1.0, "all"):
        return x, mask
    return _resize_images(x, scale), _resize_mask(mask, scale)


@pytest.mark.parametrize("scale", SCALES + ("all",))
def test_equal_key_counts_pack_densely_and_match_the_reference(small, seen, scale):
    """(a) Portrait and landscape with as many keys, the served cell's case:
    the attention sees the keys alone and no mask."""
    m, sd = small
    x, mask = _at(*canvas(EQUAL), scale)
    with torch.no_grad():
        got = _ours(m, x, mask, scale)
    want = _reference(sd, x, mask, scale)
    assert _gap(got, want) < TOL
    assert float((got[0] - got[1]).norm()) > 1000 * TOL
    assert seen and all(keep is None for _, keep in seen)
    assert keys(*EQUAL[0]) == keys(*EQUAL[1]) == SPECIAL + 48
    if scale != "all":
        n, = set(mask_keys(mask))
        assert [n for n, _ in seen] == [n] * CFG["depth"]


@pytest.mark.parametrize("scale", SCALES + ("all",))
def test_unequal_key_counts_mask_the_shorter_row_and_match_the_reference(small, seen, scale):
    """(b) The attention runs over the longer row's keys; the shorter row is
    masked past its own."""
    m, sd = small
    x, mask = _at(*canvas(UNEQUAL), scale)
    with torch.no_grad():
        got = _ours(m, x, mask, scale)
    want = _reference(sd, x, mask, scale)
    assert _gap(got, want) < TOL
    if scale == 1.0:
        long_, short = keys(*UNEQUAL[0]), keys(*UNEQUAL[1])
        assert (long_, short) == (SPECIAL + 40, SPECIAL + 32)
        assert len(seen) == CFG["depth"]
        for n, keep in seen:
            assert n == long_
            assert keep.tolist() == [[True] * long_, [True] * short + [False] * (long_ - short)]
    elif scale != "all":
        counts = mask_keys(mask)
        assert counts[0] > counts[1]
        assert all(n == counts[0] and keep.sum(1).tolist() == counts for n, keep in seen)


def test_an_all_masked_row_leaves_the_real_row_bit_for_bit(small, seen):
    """(c) A ``pad_batches`` row keeps its special tokens alone and changes
    nothing of the real row beside it."""
    m, _ = small
    x, mask = canvas([UNEQUAL[0], (0, 0)])
    with torch.no_grad():
        alone = m(x[:1], mask[:1])
        beside = m(x, mask)
    assert torch.equal(beside[0], alone[0])
    assert torch.isfinite(beside).all()
    n, keep = seen[-1]
    assert n == keys(*UNEQUAL[0])
    assert keep.sum(1).tolist() == [n, SPECIAL]


def test_without_a_mask_every_canvas_token_runs_unmasked(small, seen):
    """(d) ``mask=None`` is the plain path: every canvas token, no mask."""
    m, _ = small
    x, _ = canvas(EQUAL)
    with torch.no_grad():
        got = m(x)
    assert got.shape == (2, CFG["embed_dim"])
    assert [(n, keep) for n, keep in seen] == [(SPECIAL + GRID * GRID, None)] * CFG["depth"]


@pytest.mark.parametrize("hws, rows, key_rows", [
    (EQUAL, 2 * (SPECIAL + 48), 2 * (SPECIAL + 48)),
    (UNEQUAL, 2 * (SPECIAL + 40), 2 * SPECIAL + 40 + 32),
    (None, 2 * (SPECIAL + GRID * GRID), 2 * (SPECIAL + GRID * GRID)),
])
def test_the_counters_count_the_rows_packing_computes(small, hws, rows, key_rows):
    """(e) ``vit.token_rows`` is ``B n`` after packing, ``vit.key_rows`` the
    keys among them: equal counts leave no padding."""
    m, _ = small
    x, mask = canvas(hws or EQUAL)
    tracing.reset()
    tracing.enable()
    try:
        with torch.no_grad():
            m(x, None if hws is None else mask)
        counts = tracing.counters()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert (counts["vit.token_rows"], counts["vit.key_rows"]) == (rows, key_rows)
