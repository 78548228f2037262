"""Exact top-k (``ops.topk``) and ``FlatIndex`` against the JAX package's,
and the flat artifacts in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_flat as j_build_flat
from image_search_engine_for_historical_research_tpu.index import load_index as j_load
from image_search_engine_for_historical_research_tpu.index import save_index as j_save
from image_search_engine_for_historical_research_tpu.ops import topk as jtopk
from image_search_engine_for_historical_research_tpu_torch.index import (
    FlatIndex,
    build_flat,
    load_index,
    save_index,
)
from image_search_engine_for_historical_research_tpu_torch.ops import scan_topk as sk
from image_search_engine_for_historical_research_tpu_torch.ops import topk as ttopk
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL, BF16_TOL = 1e-5, 1e-2


def data(Q, N, D=64, seed=0):
    """Unit rows, like descriptors, so that scores lie in [-1, 1] (l2: [-3, 1])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Q + N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x[:Q], x[Q:]


def assert_topk_close(s_ref, i_ref, s, i, atol, tie=F32_TOL):
    """Scores within ``atol``; ids equal wherever the score is untied (more
    than ``tie`` from its neighbours in the row). bf16 operands multiply
    exactly into f32 in both packages, so only the summation order differs
    and ``tie`` stays the f32 tolerance for them too."""
    s_ref, i_ref, s, i = (np.asarray(a) for a in (s_ref, i_ref, s, i))
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=atol)
    gap = np.diff(s_ref, axis=1)
    untied = np.ones_like(s_ref, bool)
    untied[:, 1:] &= np.abs(gap) > tie
    untied[:, :-1] &= np.abs(gap) > tie
    np.testing.assert_array_equal(i[untied], i_ref[untied])
    assert untied.mean() > 0.9


@pytest.fixture
def budget(monkeypatch):
    """Lower the one-shot budget and ``QBLOCK`` in both packages (the JAX
    package reads them while tracing, so its trace cache is cleared)."""

    def set_(score_bytes, qblock=None):
        for mod in (jtopk, ttopk):
            monkeypatch.setattr(mod, "ONESHOT_SCORE_BYTES", score_bytes)
            if qblock is not None:
                monkeypatch.setattr(mod, "QBLOCK", qblock)
        jax.clear_caches()

    yield set_
    jax.clear_caches()


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", ["oneshot", "chunked", "chunked_short_tail", "qblock"])
def test_exact_topk_matches_jax(budget, path, metric, bf16):
    q, db = data(20, 1000, seed=len(path))
    k, kw = 10, {}
    if path == "chunked":
        budget(20 * 1000 * 4 // 2)             # two chunks of 512, the last one shorter
    elif path == "chunked_short_tail":
        budget(20 * 1000 * 4 // 2)
        k, kw = 120, {"chunk": 128}            # the last chunk (104 rows) is shorter than k
    elif path == "qblock":
        budget(20 * 1000 * 4 // 2, qblock=8)   # three query blocks, the last one padded
    mj = jnp.bfloat16 if bf16 else None
    mt = torch.bfloat16 if bf16 else None
    sj, ij = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(db), k, metric=metric,
                              matmul_dtype=mj, **kw)
    st, it = ttopk.exact_topk(torch.from_numpy(q), torch.from_numpy(db), k, metric=metric,
                              matmul_dtype=mt, **kw)
    assert st.dtype == torch.float32
    assert_topk_close(sj, ij, st, it, BF16_TOL if bf16 else F32_TOL)


def test_exact_topk_approximate_is_exact():
    q, db = data(8, 5000, seed=3)
    s, i = ttopk.exact_topk(torch.from_numpy(q), torch.from_numpy(db), 50, approximate=True)
    sj, ij = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(db), 50, approximate=True)
    assert_topk_close(sj, ij, s, i, F32_TOL)


def test_exact_topk_orders_ties_like_lax_top_k():
    """Equal scores come back lower id first, as ``lax.top_k`` orders them."""
    db = np.repeat(np.eye(4, dtype=np.float32), 3, axis=0)     # rows 0-2, 3-5, ... equal
    q = np.array([[1.0, 0.5, 0.0, 0.0]], np.float32)
    s, i = ttopk.exact_topk(torch.from_numpy(q), torch.from_numpy(db), 6)
    _, ij = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(db), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(i.numpy()[0], [0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_exact_scores_and_ranks_match_jax(metric, bf16):
    q, db = data(6, 300, seed=4)
    mj, mt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    tol = BF16_TOL if bf16 else F32_TOL
    sj = jtopk.exact_scores(jnp.asarray(q), jnp.asarray(db), metric=metric, matmul_dtype=mj)
    st = ttopk.exact_scores(torch.from_numpy(q), torch.from_numpy(db), metric=metric,
                            matmul_dtype=mt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=tol)
    rj = jtopk.exact_ranks(jnp.asarray(q), jnp.asarray(db), metric=metric, matmul_dtype=mj)
    rt = ttopk.exact_ranks(torch.from_numpy(q), torch.from_numpy(db), metric=metric,
                           matmul_dtype=mt)
    ref = np.take_along_axis(np.asarray(sj), np.asarray(rj), 1)
    assert_topk_close(ref, rj, np.take_along_axis(np.asarray(sj), rt.numpy(), 1), rt, tol)


@pytest.mark.parametrize("k", [10, 120], ids=["k10", "tail_shorter_than_k"])
def test_streaming_exact_topk_matches_jax(k):
    q, db = data(7, 1000, seed=5)
    sj, ij = jtopk.streaming_exact_topk(jnp.asarray(q), db, k, device_chunk=300)
    st, it = ttopk.streaming_exact_topk(torch.from_numpy(q), db, k, device_chunk=300)
    assert_topk_close(sj, ij, st, it, F32_TOL)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_flat_index_matches_jax(metric, storage):
    q, db = data(12, 700, seed=6)
    jix = j_build_flat(db, metric=metric, storage_dtype=storage)
    tix = build_flat(db, metric=metric, storage_dtype=storage, device="cpu")
    assert tix.vectors.dtype == (torch.bfloat16 if storage == "bfloat16" else torch.float32)
    np.testing.assert_allclose(tix.vectors.float().numpy(),
                               np.asarray(jix.vectors.astype(jnp.float32)), rtol=0, atol=1e-6)
    sj, ij = jix.search(q, 15)
    st, it = tix.search(q, 15)
    assert_topk_close(sj, ij, st, it, BF16_TOL if storage == "bfloat16" else F32_TOL)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_flat_artifacts_both_ways(storage, tmp_path):
    _, db = data(1, 200, seed=7)
    jix = j_build_flat(db, storage_dtype=storage)
    j_save(jix, str(tmp_path / "jax"))
    tix = load_index(str(tmp_path / "jax"), device="cpu")
    assert isinstance(tix, FlatIndex) and tix.storage_dtype == storage
    np.testing.assert_array_equal(tix.vectors.float().numpy(),
                                  np.asarray(jix.vectors.astype(jnp.float32)))
    save_index(tix, str(tmp_path / "port"))
    with np.load(tmp_path / "port" / "arrays.npz") as z:
        key = "vectors_bf16" if storage == "bfloat16" else "vectors"
        assert set(z) == {key} and z[key].dtype == (np.uint16 if key == "vectors_bf16"
                                                    else np.float32)
    back = j_load(str(tmp_path / "port"))
    assert back.vectors.dtype == jix.vectors.dtype
    np.testing.assert_array_equal(np.asarray(back.vectors.astype(jnp.float32)),
                                  np.asarray(jix.vectors.astype(jnp.float32)))


def test_flat_f32_persisted_bf16_artifact_loads_as_bf16():
    """Older artifacts kept bf16 vectors as f32 under ``vectors``."""
    v = np.random.default_rng(8).standard_normal((5, 8)).astype(np.float32)
    ix = FlatIndex.from_arrays({"metric": "cosine", "storage_dtype": "bfloat16"},
                               {"vectors": v}, device="cpu")
    assert ix.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(ix.vectors.float().numpy(),
                                  torch.from_numpy(v).to(torch.bfloat16).float().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_exact_topk_on_card_matches_cpu(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, db = data(70, 200_000, D=256, seed=9)
    mt = torch.bfloat16 if bf16 else None
    sc, ic = ttopk.exact_topk(torch.from_numpy(q), torch.from_numpy(db), 100, matmul_dtype=mt)
    sg, ig = ttopk.exact_topk(torch.from_numpy(q).cuda(), torch.from_numpy(db).cuda(), 100,
                              matmul_dtype=mt)
    # f32 sums in another order on each device (bf16 products are exact in f32)
    assert_topk_close(sc, ic, sg.cpu(), ig.cpu(), F32_TOL)


def test_plain_scan_topk_selects_the_lowest_ids_at_the_kth_score():
    """Rows r and r + 4 and r + 8 are equal, so the 5th score is tied three
    ways: the plain version (and the kernel) take the lowest ids, first, as
    ``_top_exact`` and ``lax.top_k`` do."""
    db = np.tile(np.eye(4, dtype=np.float32), (3, 1))
    q = np.array([[1.0, 0.5, 0.25, 0.0], [0.0, 0.25, 0.5, 1.0]], np.float32)
    s, i = sk.scan_topk(torch.from_numpy(q), torch.from_numpy(db), 5)
    s_ex, i_ex = ttopk._top_exact(torch.from_numpy(q) @ torch.from_numpy(db).T, 5)
    np.testing.assert_array_equal(i.numpy(), i_ex.numpy())
    np.testing.assert_array_equal(s.numpy(), s_ex.numpy())
    np.testing.assert_array_equal(i.numpy(), [[0, 4, 8, 1, 5], [3, 7, 11, 2, 6]])
    _, ij = jtopk.exact_topk(jnp.asarray(q), jnp.asarray(db), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


ROUTES = {
    # case: (routed to the kernel, what differs from the routed default)
    "taken": (True, {}),
    "largest_q_and_k": (True, {"Q": sk.MAX_Q, "k": sk.MAX_K}),
    "not_on_the_card": (False, {"device_check": True}),
    "l2": (False, {"metric": "l2"}),
    "bf16_matmul": (False, {"matmul_dtype": torch.bfloat16}),
    "bf16_storage": (False, {"db_dtype": torch.bfloat16}),
    "f64_queries": (False, {"q_dtype": torch.float64}),
    "q_non_contiguous": (False, {"q_layout": "transposed"}),
    "db_non_contiguous": (False, {"db_layout": "transposed"}),
    "db_misaligned": (False, {"db_layout": "offset"}),
    "q_above_the_tile": (False, {"Q": sk.MAX_Q + 1}),
    "k_above_the_list": (False, {"k": sk.MAX_K + 1}),
    "d_not_a_multiple_of_4": (False, {"D": 30}),
    "chunked_path": (False, {"budget": 8 * 300 * 4 // 2}),
}


def _layout(a, how):
    if how == "transposed":
        return a.T.contiguous().T
    if how == "offset":
        flat = torch.empty(a.numel() + 1, dtype=a.dtype)
        out = flat[1:].view(a.shape)
        out.copy_(a)
        return out
    return a


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_exact_topk_routes_to_the_kernel_exactly_when_it_takes_the_scan(monkeypatch, budget,
                                                                        case):
    """One case per condition of the route: the kernel's device, f32 ``q``
    and gallery, contiguous and 16-byte aligned, ``ip``, Q and k within the
    kernel's limits, D a multiple of 4, the one-shot path. Past the
    ``not_on_the_card`` case the refusal's device check is left out (the
    tensors are on the CPU), so the plain version stands in for the kernel."""
    routed, kw = ROUTES[case]
    if not kw.get("device_check"):
        monkeypatch.setattr(sk, "refusal", sk._operand_refusal)
    calls = []

    def spy(q, x, k):
        calls.append((tuple(q.shape), tuple(x.shape), k))
        return sk.scan_topk_reference(q, x, k)

    monkeypatch.setattr(sk, "scan_topk", spy)
    if "budget" in kw:
        budget(kw["budget"])
    Q, k, D = kw.get("Q", 8), kw.get("k", 10), kw.get("D", 32)
    qn, dbn = data(Q, 300, D=D, seed=11)
    q = _layout(torch.from_numpy(qn).to(kw.get("q_dtype", torch.float32)), kw.get("q_layout"))
    db = _layout(torch.from_numpy(dbn).to(kw.get("db_dtype", torch.float32)),
                 kw.get("db_layout"))
    s, i = ttopk.exact_topk(q, db, k, metric=kw.get("metric", "ip"),
                            matmul_dtype=kw.get("matmul_dtype"))
    assert bool(calls) == routed
    # the metric, the product's dtype and the path are the route's own conditions
    assert sk.takes(q, db, k) == (routed or case in ("l2", "bf16_matmul", "chunked_path"))
    if routed:
        assert calls == [((Q, D), (300, D), k)]
        s_ex, i_ex = ttopk._top_exact(q @ db.T, k)
        np.testing.assert_array_equal(i.numpy(), i_ex.numpy())
        np.testing.assert_array_equal(s.numpy(), s_ex.numpy())
