"""Each cell's check, driven through a whole run at a small size on the
CPU (only the look for a card is skipped): a sound run comes out correct,
and a run whose timed path is broken underneath comes out not correct,
for each fault the cell can have."""

import pytest
import torch

from perfbench.harness import core
from perfbench.tests.tiny import run_tiny

PORT = "image_search_engine_for_historical_research_tpu_torch"


def _reverse_lists(real):
    def qge1(*a, **k):
        return real(*a, **k).flip(1)
    return qge1


def _noisy_extract(real):
    def make(module, scales):
        fn = real(module, scales=scales)

        def noisy(x, mask=None):
            v = fn(x, mask)
            v = v + 1e-2 * torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
            return v / v.norm(dim=1, keepdim=True)
        return noisy
    return make


def _half_batch(real):
    def exact_topk(q, db, k, **kw):
        h = (q.shape[0] + 1) // 2
        s, i = real(q[:h], db, k, **kw)
        return torch.cat([s, s])[:q.shape[0]], torch.cat([i, i])[:q.shape[0]]
    return exact_topk


def _shifted_ids(real):
    def exact_topk(q, db, k, **kw):
        s, i = real(q, db, k, **kw)
        return s, torch.cat([i[:, :1], i[:, 2:], i[:, 1:2]], 1)   # rank 2 moved to the end
    return exact_topk


def _altered_counts(real):
    def make(matcher, *a, **k):
        fn = real(matcher, *a, **k)

        def counts(i0, i1):
            c = fn(i0, i1)
            return c + (torch.arange(len(c), device=c.device) % 2) * 5
        return counts
    return make


def _reversed_order(real):
    def rerank(ranks, counts, b):
        return real(ranks, counts, b)[:, ::-1].copy()
    return rerank


FAULTS = [
    ("solar-r1m.served-uploads", "answer altered: qge1 list reversed",
     f"{PORT}.serving.app", "qge1", _reverse_lists),
    ("solar-r1m.served-uploads", "answer altered: descriptor perturbed where produced",
     f"{PORT}.serving.app", "make_extract_fn", _noisy_extract),
    ("solar-r1m.served-uploads", "answer altered: shortlist order broken",
     f"{PORT}.index.flat", "exact_topk", _shifted_ids),
    ("solar-r1m.batch-q70", "answer altered: qge1 list reversed",
     f"{PORT}.rerank.qe", "qge1", _reverse_lists),
    ("solar-r1m.batch-q70", "half of the batch left out",
     f"{PORT}.index.flat", "exact_topk", _half_batch),
    ("solar-r1m.batch-q70", "answer altered: shortlist order broken",
     f"{PORT}.index.flat", "exact_topk", _shifted_ids),
    ("loftr-outdoor.verify-b60", "answer altered: counts changed where produced",
     f"{PORT}.models.loftr", "make_batched_count_fn", _altered_counts),
    ("loftr-outdoor.verify-b60", "answer altered: re-ranked order reversed",
     f"{PORT}.rerank.geometric", "rerank_by_inliers", _reversed_order),
]


@pytest.mark.parametrize("cell", sorted({f[0] for f in FAULTS}))
def test_a_sound_run_is_correct(cell):
    _, out = run_tiny(cell)
    assert core.judge(out), [(c.name, c.value, c.limit) for c in out.checks]


@pytest.mark.parametrize("cell,fault,module,attr,breaker", FAULTS,
                         ids=[f"{f[0]}:{f[1]}" for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, module, attr, breaker):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, breaker(getattr(mod, attr)))
    _, out = run_tiny(cell)
    assert not core.judge(out), (fault, [(c.name, c.value, c.limit) for c in out.checks])
