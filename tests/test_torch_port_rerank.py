"""The port's AQE, DBA and k-reciprocal re-ranking (``rerank/qe.py``,
``rerank/kr.py``) against the JAX package's on the same seeded numpy inputs.

Tolerances: augmented descriptors within 1e-5; ranks equal (the k-reciprocal
ranks over the head that JAX's own chunked-vs-dense test holds equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.ops.topk import exact_ranks as j_exact_ranks
from image_search_engine_for_historical_research_tpu.rerank import kr as jkr
from image_search_engine_for_historical_research_tpu.rerank import qe as jqe
from image_search_engine_for_historical_research_tpu_torch.ops import scan_topk as sk
from image_search_engine_for_historical_research_tpu_torch.ops.topk import (
    _top,
    exact_ranks,
    exact_scores,
    exact_topk,
)
from image_search_engine_for_historical_research_tpu_torch.rerank import kr as tkr
from image_search_engine_for_historical_research_tpu_torch.rerank import qe as tqe
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def t(x):
    return torch.as_tensor(np.asarray(x))


def clustered(n, d, n_centers, spread, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d))
    x = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    g = clustered(300, 48, 10, 0.5, seed=0)
    rng = np.random.default_rng(1)
    q = g[rng.choice(300, 7, replace=False)] + 0.1 * rng.standard_normal((7, 48))
    return q.astype(np.float32), g


@pytest.mark.parametrize("name", ["average_query_expansion", "database_augmentation"])
@pytest.mark.parametrize("top_k", [1, 3])
def test_aqe_dba_match_jax(data, name, top_k):
    q, g = data
    qa_j, va_j = getattr(jqe, name)(jnp.asarray(q), jnp.asarray(g), top_k=top_k)
    qa_t, va_t = getattr(tqe, name)(t(q), t(g), top_k=top_k)
    assert qa_t.shape == qa_j.shape and va_t.shape == va_j.shape
    np.testing.assert_allclose(qa_t.numpy(), np.asarray(qa_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(va_t.numpy(), np.asarray(va_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(exact_ranks(qa_t, va_t).numpy(),
                                  np.asarray(j_exact_ranks(qa_j, va_j)))


def test_qge1_out_k_puts_lower_id_first_on_ties():
    """Serving qge1's top-``out_k`` orders equal scores by id (lax.top_k):
    duplicated gallery rows give exact ties."""
    g = clustered(40, 16, 4, 0.3, seed=3)
    g = np.concatenate([g, g[:10]])                       # ids 40..49 repeat 0..9
    ranks = torch.as_tensor([[0, 40, 1]])
    got = tqe.qge1(ranks, None, t(g), k=3, out_k=12)
    want = jqe.qge1(jnp.asarray(ranks.numpy()), None, jnp.asarray(g), k=3, out_k=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("routed", [False, True], ids=["gemm_and_topk", "scan_kernel_route"])
@pytest.mark.parametrize("out_k", [5, 60])
def test_qge1_topk_through_exact_topk_gives_the_old_ids(monkeypatch, routed, out_k):
    """Serving qge1 now takes its top-``out_k`` from ``exact_topk`` (the
    scan kernel's route on the card): on tie-free inputs it gives the ids
    that the full score matrix and ``_top`` gave. ``routed`` leaves the
    kernel's device check out, so the route runs with the plain version."""
    rng = np.random.default_rng(5)                        # unclustered: tie-free scores
    g, q = (a / np.linalg.norm(a, axis=1, keepdims=True)
            for a in (rng.standard_normal((400, 48), np.float32),
                      rng.standard_normal((7, 48), np.float32)))
    if routed:
        monkeypatch.setattr(sk, "refusal", sk._operand_refusal)
    before = sk.launches
    calls = []
    plain = sk.scan_topk

    def spy(*a):
        calls.append(a[2])
        return plain(*a)

    monkeypatch.setattr(sk, "scan_topk", spy)
    ranks = exact_topk(t(q), t(g), 10)[1]
    got = tqe.qge1(ranks, t(q), t(g), k=3, out_k=out_k)
    scores = exact_scores(tqe._enhance(ranks, t(g), 3, 4.0), t(g))
    top = torch.sort(scores, dim=1, descending=True).values[:, :out_k + 1]
    assert float(top.diff(dim=1).abs().min()) > 1e-6     # tie-free
    np.testing.assert_array_equal(got.numpy(), _top(scores, out_k)[1].numpy())
    assert calls == ([10, out_k] if routed else [])
    assert sk.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_kr_dense_matches_jax(seed):
    g = clustered(260, 32, 8, 0.6, seed=seed)
    rng = np.random.default_rng(seed + 10)
    q = g[rng.choice(260, 5, replace=False)] + 0.05 * rng.standard_normal((5, 32))
    q = q.astype(np.float32)
    scores_j = np.asarray(jkr.kr_rerank_scores(jnp.asarray(q), jnp.asarray(g)))
    scores_t = tkr.kr_rerank_scores(t(q), t(g))
    np.testing.assert_allclose(scores_t.numpy(), scores_j, rtol=1e-5, atol=1e-5)
    ranks_j = np.asarray(jkr.kr_rerank(q, g, method="dense"))
    ranks_t = tkr.kr_rerank(t(q), t(g), method="dense").numpy()
    np.testing.assert_array_equal(ranks_t[:, :100], ranks_j[:, :100])


def test_kr_chunked_matches_dense_and_jax():
    """Uneven chunk edges; the chunked path's ranks equal the dense path's
    and JAX's chunked ranks."""
    rng = np.random.RandomState(3)
    q = rng.randn(9, 48).astype(np.float32)
    g = rng.randn(401, 48).astype(np.float32)
    dense = tkr.kr_rerank(t(q), t(g), method="dense").numpy()
    chunked = tkr.kr_rerank_chunked(t(q), t(g), row_chunk=128, set_chunk=53,
                                    jaccard_chunk=97).numpy()
    np.testing.assert_array_equal(dense[:, :50], chunked[:, :50])
    ref = np.asarray(jkr.kr_rerank_chunked(q, g, row_chunk=128, set_chunk=53))
    np.testing.assert_array_equal(chunked[:, :50], ref[:, :50])
    np.testing.assert_array_equal(
        tkr.kr_rerank(t(q), t(g), method="chunked").numpy()[:, :50], chunked[:, :50])


def test_kr_compaction_overflow_rerun_is_exact(monkeypatch):
    """A ``compact_width`` too narrow for the data raises the overflow flag
    and the pass runs again at full width: the ranks equal the full-width
    pass at any budget, and the re-run happens exactly when a row is wider."""
    rng = np.random.RandomState(5)
    centers = rng.randn(12, 32).astype(np.float32)
    g = (centers[:, None] + 0.05 * rng.randn(12, 30, 32)).reshape(-1, 32)
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    q = g[:7]
    dense = tkr.kr_rerank(t(q), t(g), method="dense").numpy()
    full = tkr.kr_rerank_chunked(t(q), t(g), row_chunk=128, set_chunk=53,
                                 compact_width=0).numpy()
    np.testing.assert_array_equal(dense[:, :100], full[:, :100])
    # past the head this duplicated fixture has equal final distances, whose
    # order depends on the last bit of each package's sums
    np.testing.assert_array_equal(
        full[:, :100], np.asarray(jkr.kr_rerank_chunked(q, g, row_chunk=128, set_chunk=53,
                                                        compact_width=0))[:, :100])

    calls = []
    program = tkr._kr_chunked_program

    def spy(*args, **kw):
        out = program(*args, **kw)
        calls.append((kw["compact_width"], bool(out[1])))
        return out

    monkeypatch.setattr(tkr, "_kr_chunked_program", spy)
    for width in (8, 48, 96):
        calls.clear()
        compact = tkr.kr_rerank_chunked(t(q), t(g), row_chunk=128, set_chunk=53,
                                        compact_width=width).numpy()
        np.testing.assert_array_equal(full, compact, err_msg=f"width={width}")
        overflowed = calls[0][1]
        assert [c[0] for c in calls] == ([width, 0] if overflowed else [width])
    assert calls[0] == (96, False)              # 96 holds this data's sets
    calls.clear()
    tkr.kr_rerank_chunked(t(q), t(g), row_chunk=128, set_chunk=53, compact_width=8)
    assert calls == [(8, True), (0, False)]     # 8 does not: one full-width re-run


def test_kr_dense_guard_raises():
    q = np.zeros((5, 8), np.float32)
    g = np.lib.stride_tricks.as_strided(      # 120k logical rows, no real memory
        np.zeros((1, 8), np.float32), shape=(120_000, 8), strides=(0, 4))
    with pytest.raises(ValueError, match="O\\(n\\^2\\)"):
        tkr.kr_rerank(q, g, method="dense")
    with pytest.raises(ValueError, match="budget is 0.0 GiB"):
        tkr.kr_rerank(q[:2], g[:10], method="dense", max_bytes=10)
