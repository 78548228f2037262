"""The device HNSW graph builder (``index.graph_build``) against the JAX
package's: every stage on identical inputs, the whole build, and the JAX
package's graph invariants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import HNSWIndex as JHNSWIndex
from image_search_engine_for_historical_research_tpu.index import graph_build as jgb
from image_search_engine_for_historical_research_tpu_torch.index import (
    FlatIndex,
    HNSWIndex,
    build_hnsw_device,
)
from image_search_engine_for_historical_research_tpu_torch.index import graph_build as tgb
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def clustered(N=1000, D=32, k=25, seed=0, spread=0.2):
    """``tests/test_index_graph.py``'s fixture data."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, D)).astype(np.float32)
    x = centers[rng.integers(0, k, N)] + spread * rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def both_bf16(x):
    """The same bf16 rows in both packages (round-to-nearest-even either side)."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    return j, t


def recall_at(exact, approx, k):
    exact, approx = np.asarray(exact)[:, :k], np.asarray(approx)[:, :k]
    return np.mean([len(set(exact[i]) & set(approx[i])) / k for i in range(exact.shape[0])])


def candidates(x, K, seed):
    """Candidate lists as the kNN pass gives them: ids by ascending distance
    (self excluded), f32 scores, some rows cut short with -1 / -inf."""
    s = x @ x.T
    np.fill_diagonal(s, -np.inf)
    ids = np.argsort(-s, axis=1, kind="stable")[:, :K].astype(np.int32)
    sc = np.take_along_axis(s, ids, 1).astype(np.float32)
    rng = np.random.default_rng(seed)
    cut = rng.integers(K // 2, K + 1, x.shape[0])
    tail = np.arange(K)[None, :] >= cut[:, None]
    ids[tail], sc[tail] = -1, -np.inf
    return ids, sc


@pytest.mark.parametrize("K, m", [(24, 16), (8, 16)], ids=["K>m", "K<m"])
def test_prune_core_matches_jax(K, m):
    x = clustered(200, 32, 8, seed=1)
    jv, tv = both_bf16(x)
    ids, sc = candidates(np.asarray(jv.astype(jnp.float32)), K, seed=2)
    ji, js, jk = jgb._prune_chunk(jv, jnp.asarray(ids), jnp.asarray(sc), m, 1.2)
    ti, ts, tk = tgb._prune_core(tv, torch.from_numpy(ids), torch.from_numpy(sc), m, 1.2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.float().mean() < m        # the heuristic prunes and keeps


def test_dedup_rows_matches_jax_and_numpy():
    rng = np.random.default_rng(7)
    ids = rng.integers(-1, 12, size=(50, 24)).astype(np.int32)
    sc = rng.standard_normal((50, 24)).astype(np.float32)
    ji, js = jgb._dedup_rows_dev(jnp.asarray(ids), jnp.asarray(sc))
    ti, ts = tgb._dedup_rows_dev(torch.from_numpy(ids), torch.from_numpy(sc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ids_np, sc_np = ids.copy(), sc.copy()
    tgb._dedup_rows(ids_np, sc_np)
    np.testing.assert_array_equal(ids_np, ti.numpy())
    np.testing.assert_array_equal(sc_np, ts.numpy())


def test_dedup_np_rows_matches_jax():
    rng = np.random.default_rng(8)
    ids = rng.integers(-1, 20, size=(40, 30)).astype(np.int32)
    a, b = ids.copy(), ids.copy()
    jgb._dedup_np_rows(a)
    tgb._dedup_np_rows(b)
    np.testing.assert_array_equal(b, a)
    assert (b != ids).any()


def test_drop_self_chunk_matches_jax():
    ix = np.array([[5, 3, 9, 1], [2, 6, 4, 8], [1, 2, 3, 7], [9, 4, 2, 0]], np.int32)
    rng = np.random.default_rng(9)
    ix = np.concatenate([ix, rng.integers(0, 12, (12, 4)).astype(np.int32)])
    sc = np.arange(ix.size, dtype=np.float32).reshape(ix.shape)
    js, ji = jgb._drop_self_chunk(jnp.asarray(sc), jnp.asarray(ix), jnp.int32(5))
    ts, ti = tgb._drop_self_chunk(torch.from_numpy(sc), torch.from_numpy(ix).long(), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy()[:4], [[3, 9, 1], [2, 4, 8], [1, 2, 3], [9, 4, 2]])


def test_gather_backlinks_matches_jax():
    """Random pruned rows with -1 slots, self loops, backfill beyond
    ``fwd_kept`` and scores rounded so that many tie: the stable
    (destination, score, source) order and the per-destination cap decide."""
    rng = np.random.default_rng(10)
    N, m0 = 150, 8
    pruned = rng.integers(-1, N, (N, m0)).astype(np.int32)
    pruned[::7, 0] = np.arange(0, N, 7)                     # self loops
    pruned_sc = np.round(rng.uniform(-1, 1, (N, m0)), 1).astype(np.float32)
    pruned_sc[pruned < 0] = -np.inf
    fwd_kept = rng.integers(0, m0 + 1, N).astype(np.int32)
    ji, js = jgb._gather_backlinks_dev(jnp.asarray(pruned), jnp.asarray(pruned_sc),
                                       jnp.asarray(fwd_kept))
    ti, ts = tgb._gather_backlinks_dev(torch.from_numpy(pruned), torch.from_numpy(pruned_sc),
                                       torch.from_numpy(fwd_kept))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy() >= 0).sum(1).max() == m0             # some node hits the cap


def test_union_reprune_matches_jax():
    x = clustered(200, 32, 8, seed=3)
    jv, tv = both_bf16(x)
    c_ids, c_sc = candidates(np.asarray(jv.astype(jnp.float32)), 20, seed=4)
    rng = np.random.default_rng(5)
    b_ids = rng.integers(-1, 200, (200, 12)).astype(np.int32)
    b_ids[:, :3] = c_ids[:, 5:8]                            # backlinks repeat candidates
    xf = np.asarray(jv.astype(jnp.float32))
    b_sc = np.where(b_ids >= 0, np.einsum("nd,nkd->nk", xf, xf[np.maximum(b_ids, 0)]),
                    -np.inf).astype(np.float32)
    ji, jk = jgb._union_reprune_chunk(jv, jnp.asarray(c_ids), jnp.asarray(c_sc),
                                      jnp.asarray(b_ids), jnp.asarray(b_sc), 16, 1.2)
    ti, tk = tgb._union_reprune_chunk(tv, *(torch.from_numpy(a) for a in
                                            (c_ids, c_sc, b_ids, b_sc)), 16, 1.2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.fixture(scope="module")
def both_builds():
    x = clustered()
    jv, tv = both_bf16(x)
    kw = dict(m=16, k_candidates=48, batch=512)
    jg = jgb.build_hnsw_graph_tpu(jv, **kw)
    tg = tgb.build_hnsw_graph_device(tv, **kw)
    return x, jv, tv, jg, tg


def test_whole_build_matches_jax(both_builds):
    x, jv, tv, (j_nbr0, j_nbru, j_lv, j_entry, j_top), (t_nbr0, t_nbru, t_lv, t_entry, t_top) = (
        both_builds)
    np.testing.assert_array_equal(t_lv, j_lv)
    assert (t_entry, t_top) == (j_entry, j_top)
    assert t_nbr0.shape == j_nbr0.shape == (1000, 32) and t_nbr0.dtype == np.int32
    same_rows = (t_nbr0 == j_nbr0).all(1).mean()
    assert same_rows >= 0.99, same_rows
    assert (t_nbru == j_nbru).all(2).mean() >= 0.99

    # both graphs searched the JAX default way (lockstep) and the port's (kernel
    # route; its plain version on the CPU), recall against the exact top-10
    rng = np.random.default_rng(99)
    q = x[rng.integers(0, 1000, 15)] + 0.02 * rng.standard_normal((15, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _, exact = FlatIndex(torch.from_numpy(x)).search(q, 10)
    coarse = np.where(j_lv >= 1)[0].astype(np.int32)
    jix = JHNSWIndex(vectors=jv, nbr0=jnp.asarray(j_nbr0), nbru=jnp.asarray(j_nbru),
                     entry=j_entry, coarse_ids=jnp.asarray(coarse))
    tix = HNSWIndex(vectors=tv, nbr0=torch.from_numpy(t_nbr0), nbru=torch.from_numpy(t_nbru),
                    entry=t_entry, coarse_ids=torch.from_numpy(coarse))
    r_jax = recall_at(exact, jix.search(q, 10, ef=128)[1], 10)
    r_kernel = recall_at(exact, tix.search(q, 10, ef=128)[1], 10)
    r_lock = recall_at(exact, tix.search(q, 10, ef=128, use_kernel=False)[1], 10)
    assert r_kernel > 0.9 and r_lock > 0.9, (r_kernel, r_lock)
    assert abs(r_kernel - r_jax) <= 0.02 and abs(r_lock - r_jax) <= 0.02, (r_jax, r_kernel, r_lock)


def test_build_hnsw_device_index(both_builds):
    """The index builder over a numpy f32 source: normalized bf16 vectors,
    the graph of ``build_hnsw_graph_device``, coarse ids = level >= 1."""
    x, _, tv, _, (t_nbr0, _, t_lv, t_entry, _) = both_builds
    ix = build_hnsw_device(x * 3.0, m=16, k_candidates=48, batch=512, device="cpu")
    assert ix.vectors.dtype == torch.bfloat16 and ix.ef_default == 100
    np.testing.assert_array_equal(ix.vectors.float().numpy(), tv.float().numpy())
    np.testing.assert_array_equal(ix.nbr0.numpy(), t_nbr0)
    np.testing.assert_array_equal(ix.coarse_ids.numpy(), np.where(t_lv >= 1)[0])
    assert ix.entry == t_entry


def test_tight_clusters_stay_reachable():
    """20 clusters of 40, tighter than k_candidates: the hierarchy splice
    must keep the level-0 graph connected across clusters."""
    rng = np.random.default_rng(0)
    C, per, D = 20, 40, 32
    centers = rng.standard_normal((C, D)).astype(np.float32)
    db = (centers.repeat(per, 0) + 0.1 * rng.standard_normal((C * per, D))).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    ix = build_hnsw_device(db, m=8, k_candidates=32, device="cpu")
    q = db[::per][:10]
    k = 2 * per
    s, i = ix.search(q, k, ef=2 * k)
    assert torch.isfinite(s).all()
    _, ei = FlatIndex(torch.from_numpy(db)).search(q, k)
    assert recall_at(ei, i, k) > 0.85


def test_reverse_edges_give_outliers_in_degree():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 32)).astype(np.float32) * 0.05
    x[0] += 10.0
    ix = build_hnsw_device(x, m=4, k_candidates=16, batch=128, device="cpu")
    nbr0 = ix.nbr0.numpy()
    assert np.bincount(nbr0[nbr0 >= 0], minlength=300)[0] >= 1
    assert (nbr0 >= 0).sum(1).min() >= 1
    _, idx = ix.search(x[:1], 1, ef=32)
    assert int(idx[0, 0]) == 0


def test_small_gallery_m0_exceeds_candidates():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 16)).astype(np.float32)
    ix = build_hnsw_device(x, m=16, batch=16, device="cpu")   # m0=32 > k_candidates=29
    _, idx = ix.search(x[:5], 3, ef=16)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(5))


@pytest.mark.cuda
def test_device_build_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = clustered(4000, 64, 40, seed=2)
    kw = dict(m=16, k_candidates=64, batch=1024)
    gpu = build_hnsw_device(x, device="cuda", **kw)
    cpu = build_hnsw_device(x, device="cpu", **kw)
    assert gpu.entry == cpu.entry
    torch.testing.assert_close(gpu.coarse_ids.cpu(), cpu.coarse_ids, rtol=0, atol=0)
    same = (gpu.nbr0.cpu() == cpu.nbr0).all(1).float().mean().item()
    assert same >= 0.99, same
