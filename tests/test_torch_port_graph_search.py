"""The lockstep HNSW traversal (``ops.graph_search.hnsw_search_batch``) and
``HNSWIndex.search(use_kernel=False)`` against the JAX package's, and a bf16
index through the kernel route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build
from image_search_engine_for_historical_research_tpu.ops.graph_search import (
    hnsw_search_batch as j_search,
)
from image_search_engine_for_historical_research_tpu_torch.index import HNSWIndex
from image_search_engine_for_historical_research_tpu_torch.index.base import normalize_rows
from image_search_engine_for_historical_research_tpu_torch.ops.graph_search import (
    hnsw_search_batch,
)
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _clustered(n, d, k, seed, spread=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def graph():
    x = _clustered(600, 32, 20, seed=4)
    rng = np.random.default_rng(5)
    q = x[rng.integers(0, 600, 12)] + 0.05 * rng.standard_normal((12, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jix = j_build(x, m=8, ef_construction=48)
    tix = HNSWIndex(
        vectors=torch.from_numpy(np.array(jix.vectors)),
        nbr0=torch.from_numpy(np.array(jix.nbr0)),
        nbru=torch.from_numpy(np.array(jix.nbru)),
        entry=jix.entry, ef_default=jix.ef_default,
        coarse_ids=torch.from_numpy(np.array(jix.coarse_ids)),
    )
    return x, q, jix, tix


@pytest.mark.parametrize("seeded", [False, True], ids=["descent_only", "coarse_seeds"])
@pytest.mark.parametrize("k, ef", [(10, 32), (5, 5)])
def test_hnsw_search_batch_matches_jax(graph, seeded, k, ef):
    _, q, jix, tix = graph
    coarse = jix.coarse_ids if seeded else None
    sj, ij = j_search(jix.vectors, jix.nbr0, jix.nbru, jix.entry, jnp.asarray(q), k, ef,
                      coarse_ids=coarse)
    st, it = hnsw_search_batch(tix.vectors, tix.nbr0, tix.nbru, tix.entry, torch.from_numpy(q),
                               k, ef, coarse_ids=tix.coarse_ids if seeded else None)
    assert it.dtype == torch.int32 and it.shape == (12, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_search_without_kernel_matches_jax_default(graph):
    _, q, jix, tix = graph
    sj, ij = jix.search(q, 10, ef=40)                 # the JAX default route
    st, it = tix.search(q, 10, ef=40, use_kernel=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_finished_queries_keep_their_beams(graph):
    """A query alone and the same query in a batch whose other queries run
    longer give the same beam (the batch masks finished queries)."""
    _, q, _, tix = graph
    qt = normalize_rows(torch.from_numpy(q))
    s_all, i_all = hnsw_search_batch(tix.vectors, tix.nbr0, tix.nbru, tix.entry, qt, 10, 24,
                                     coarse_ids=tix.coarse_ids)
    for r in range(0, 12, 5):
        s_one, i_one = hnsw_search_batch(tix.vectors, tix.nbr0, tix.nbru, tix.entry,
                                         qt[r:r + 1], 10, 24, coarse_ids=tix.coarse_ids)
        np.testing.assert_array_equal(i_one.numpy()[0], i_all.numpy()[r])
        np.testing.assert_array_equal(s_one.numpy()[0], s_all.numpy()[r])


def test_node0_reachable_through_expansion():
    """The JAX regression case: -1 padding and already-visited slots must not
    mark node 0 visited (chain 3 -> 2 -> 1 -> 0, node 0 nearest)."""
    vectors = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    nbr0 = torch.tensor([[1, -1], [2, 0], [3, 1], [2, -1]], dtype=torch.int32)
    nbru = torch.zeros((0, 4, 2), dtype=torch.int32)
    _, ids = hnsw_search_batch(vectors, nbr0, nbru, 3, torch.zeros(1, 2), k=2, ef=4)
    assert int(ids[0, 0]) == 0


def test_bf16_index_kernel_route(graph):
    """An index holding bf16 vectors (as the device builder stores them)
    searches through the kernel route: the coarse entry scores are taken in
    the queries' f32 (a bf16 gallery against f32 queries raised a dtype
    error before), and the beams equal those of the lockstep route on the
    same bf16 index at the top."""
    x, q, _, tix = graph
    bix = HNSWIndex(vectors=tix.vectors.to(torch.bfloat16), nbr0=tix.nbr0, nbru=tix.nbru,
                    entry=tix.entry, ef_default=tix.ef_default, coarse_ids=tix.coarse_ids)
    s, i = bix.search(q, 10, ef=48)
    assert s.dtype == torch.float32 and i.shape == (12, 10)
    _, i_lock = bix.search(q, 10, ef=48, use_kernel=False)
    np.testing.assert_array_equal(i[:, 0].numpy(), i_lock[:, 0].numpy())
    exact = np.argsort(-(q @ x.T), axis=1)[:, :10]
    recall = np.mean([len(set(i[r].tolist()) & set(exact[r])) / 10 for r in range(12)])
    assert recall > 0.9, recall
    meta, arrays = bix.to_arrays()                    # f32 on disk, as JAX stores it
    assert arrays["vectors"].dtype == np.float32
    back = HNSWIndex.from_arrays(meta, arrays, device="cpu")
    torch.testing.assert_close(back.vectors, bix.vectors.float(), rtol=0, atol=0)
