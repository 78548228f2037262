"""``HNSWPQIndex`` / ``build_hnsw_pq`` and the PQ graph walks of the port
against the JAX package: builds with JAX's fits substituted (native and
device graph builders, with and without refine codes and OPQ, the
first-member fallback), every search method on one artifact both ways,
streaming builds and the refused requests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_hnsw_pq as j_build
from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import save_index as j_save_index
from image_search_engine_for_historical_research_tpu.ops import pq as jpq
from image_search_engine_for_historical_research_tpu_torch.index import (
    HNSWPQIndex,
    build_hnsw_pq,
    load_index,
    save_index,
)
from image_search_engine_for_historical_research_tpu_torch.index import streaming
from image_search_engine_for_historical_research_tpu_torch.ops import pq as tpq
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_arrays,
    assert_same_ranks,
    clustered_rows,
    one_torch_thread,
    substitute_jax_fits,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METHODS = ["adc", "adc+rerank", "adc+refine", "graph", "graph+refine"]


@pytest.fixture(scope="module")
def data():
    x = clustered_rows(n=700, n_centers=40, seed=3)
    rng = np.random.default_rng(2)
    q = x[rng.integers(0, len(x), 8)] + 0.05 * rng.standard_normal((8, x.shape[1]))
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _assert_node_codes_tie(jarr, tarr, tix):
    """Node codes are the refine encoding of a mean member residual; the
    mean of two members lies on the boundary between their codewords, so a
    differing node code must be as near the port's own mean as JAX's is."""
    nj, nt = jarr["node_codes"], tarr["node_codes"]
    rows = np.nonzero((nj != nt).any(1))[0]
    assert len(rows) <= max(2, len(nj) // 10), len(rows)
    if len(rows):
        rcb = tpq.PQCodebook(tix.refine_codewords, tix.refine_rotation)
        dec = tpq.pq_decode(rcb, torch.from_numpy(tarr["refine_codes"]))
        offs, members = tarr["group_offsets"], tarr["group_members"]
        mean = torch.stack([dec[members[offs[r]:offs[r + 1]]].mean(0) for r in rows])
        d_t = ((tpq.pq_decode(rcb, torch.from_numpy(nt[rows])) - mean) ** 2).sum(1)
        d_j = ((tpq.pq_decode(rcb, torch.from_numpy(nj[rows])) - mean) ** 2).sum(1)
        np.testing.assert_allclose(d_j.numpy(), d_t.numpy(), rtol=0, atol=1e-5)
    same = ~(nj != nt).any(1)
    np.testing.assert_allclose(tarr["node_norm2"][same], jarr["node_norm2"][same], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"builder": "native", "refine_M": 0},
    {"builder": "native", "refine_M": 8},
    {"builder": "native", "refine_M": 8, "opq": True, "opq_iters": 2},
    {"builder": "tpu", "refine_M": 8, "opq": "refine", "opq_iters": 2},
    {"builder": "tpu", "refine_M": 8, "max_graph_bytes": 200_000},   # first-member fallback
])
def test_build_equals_jax_with_its_fits(data, monkeypatch, kw):
    x, q = data
    substitute_jax_fits(monkeypatch)
    common = dict(M=8, Ks=64, iters=6, normalize=False, graph_k_candidates=24)
    jix = j_build(x, **common, **kw)
    tix = build_hnsw_pq(x, device="cpu", **common, **kw)
    jm, jarr = jix.to_arrays()
    tm, tarr = tix.to_arrays()
    assert tm == jm
    assert_same_arrays(jarr, tarr, skip=("node_codes", "node_norm2"))
    if "node_codes" in jarr:
        if "max_graph_bytes" in kw:        # each node's first member's refine code
            np.testing.assert_array_equal(
                tarr["node_codes"], tarr["refine_codes"][tarr["group_members"][
                    tarr["group_offsets"][:-1]]])
            np.testing.assert_array_equal(tarr["node_codes"], jarr["node_codes"])
            np.testing.assert_allclose(tarr["node_norm2"], jarr["node_norm2"], rtol=0, atol=1e-5)
        else:
            _assert_node_codes_tie(jarr, tarr, tix)
    for method in ("adc", "adc+refine") if kw["refine_M"] else ("adc", "graph"):
        sj, ij = jix.search(q, 10, method=method)
        st, it = tix.search(q, 10, method=method)
        assert_same_ranks(sj, ij, st, it)


@pytest.fixture(scope="module")
def jax_artifact(data, tmp_path_factory):
    """A JAX-built index with OPQ on both levels, refine codes and node
    centroids, saved."""
    x, _ = data
    path = tmp_path_factory.mktemp("hnsw_pq") / "j"
    jix = j_build(x, M=8, Ks=64, iters=5, refine_M=8, opq=True, opq_iters=2, builder="native")
    j_save_index(jix, str(path))
    return jix, str(path)


@pytest.mark.parametrize("method, centroid_walk", [(m, True) for m in METHODS]
                         + [("graph", False), ("graph+refine", False)])
def test_jax_artifact_searches_the_same_in_the_port(data, jax_artifact, method, centroid_walk):
    x, q = data
    jix, path = jax_artifact
    tix = load_index(path, device="cpu")
    assert isinstance(tix, HNSWPQIndex) and tix.n == len(x)
    kw = dict(ef=40, n_seeds=4, centroid_walk=centroid_walk, expand=3)
    vec = x / np.linalg.norm(x, axis=1, keepdims=True)
    sj, ij = jix.search(q, 10, method=method, vectors=jnp.asarray(vec), **kw)
    st, it = tix.search(q, 10, method=method, vectors=torch.from_numpy(vec), **kw)
    assert it.dtype == torch.int32
    assert_same_ranks(sj, ij, st, it)


def test_port_artifact_loads_in_jax(data, tmp_path):
    x, q = data
    tix = build_hnsw_pq(x, M=8, Ks=64, iters=4, refine_M=8, opq="refine", opq_iters=2,
                        device="cpu")
    save_index(tix, str(tmp_path / "t"))
    jix = j_load_index(str(tmp_path / "t"))
    assert_same_arrays(tix.to_arrays()[1], jix.to_arrays()[1], atol=0)
    for method in ("adc+refine", "graph+refine"):
        sj, ij = jix.search(q, 10, method=method)
        st, it = tix.search(q, 10, method=method)
        assert_same_ranks(sj, ij, st, it)


def test_expand_members_and_backfill_match_jax(data, jax_artifact):
    """A query that asks for more slots than the index has images is
    backfilled with unlisted ids, as in JAX."""
    x, q = data
    jix, path = jax_artifact
    tix = load_index(path, device="cpu")
    rng = np.random.default_rng(0)
    idx_u = rng.integers(-1, tix.unique_codes.shape[0], (5, 30))
    scores = rng.standard_normal((5, 30)).astype(np.float32)
    for got, ref in zip(tix._expand_members(idx_u, scores, 50), jix._expand_members(idx_u, scores,
                                                                                      50)):
        np.testing.assert_array_equal(got, ref)
    sj, ij = jix.search(q[:2], len(x) + 5, method="adc")
    st, it = tix.search(q[:2], len(x) + 5, method="adc")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_streaming_build_equals_in_memory(data, as_tensor):
    x, _ = data
    kw = dict(M=8, Ks=64, iters=4, refine_M=8, opq="refine", opq_iters=2, train_sample=500,
              device="cpu")
    mem = build_hnsw_pq(x, **kw)

    def chunks():
        for s in range(0, len(x), 300):
            yield torch.from_numpy(x[s:s + 300].copy()) if as_tensor else x[s:s + 300]

    st = build_hnsw_pq(chunks, n=len(x), **kw)
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)


def test_list_donation_and_refused_requests(data):
    x, q = data
    holder = [x]
    ix = build_hnsw_pq(holder, M=8, Ks=32, iters=2, refine_M=0, device="cpu")
    assert holder == []
    jix = j_build([x], M=8, Ks=32, iters=2, refine_M=0)
    cases = [
        (lambda: jix.search(q, 5, method="adc+rerank"), lambda: ix.search(q, 5, method="adc+rerank")),
        (lambda: jix.search(q, 5, method="adc+refine"), lambda: ix.search(q, 5, method="adc+refine")),
        (lambda: jix.search(q, 5, method="graph+refine"),
         lambda: ix.search(q, 5, method="graph+refine")),
        (lambda: j_build(lambda: iter([x]), M=8, Ks=32),
         lambda: build_hnsw_pq(lambda: iter([x]), M=8, Ks=32, device="cpu")),
        (lambda: j_build(x, M=8, Ks=32, opq="both"),
         lambda: build_hnsw_pq(x, M=8, Ks=32, opq="both", device="cpu")),
    ]
    for jcall, tcall in cases:
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="max_graph_bytes"):
        build_hnsw_pq(x, M=8, Ks=32, iters=1, refine_M=0, builder="device", max_graph_bytes=10,
                      device="cpu")


def test_pq_walk_luts_are_jax_s(data, jax_artifact):
    """The walks' distance: the ADC sum of a code row equals JAX's ``_adc``."""
    from image_search_engine_for_historical_research_tpu.ops import graph_search as jgs
    from image_search_engine_for_historical_research_tpu_torch.ops import graph_search as tgs

    x, q = data
    jix, _ = jax_artifact
    lut = np.asarray(jpq.pq_dist_table(jpq.PQCodebook(jix.codewords), jnp.asarray(q)))
    codes = np.asarray(jix.unique_codes).astype(np.int64)[:50]
    ref = np.stack([np.asarray(jgs._adc(jnp.asarray(lut[i]), jnp.asarray(codes))) for i in
                    range(len(q))])
    got = tgs._adc(torch.from_numpy(lut), torch.from_numpy(codes)[None].expand(len(q), -1, -1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # one code set for every LUT row (the coarse seeds, the flat scan)
    assert torch.equal(tgs._adc(torch.from_numpy(lut), torch.from_numpy(codes)), got)


@pytest.mark.cuda
def test_two_card_builds_from_one_seed_are_identical(data, monkeypatch):
    """The device graph builder and the node centroid sums on the card: two
    builds from one seed give identical arrays, and so does a build
    streamed from host chunks that straddle the pieces of a 256-row grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, _ = data
    monkeypatch.setattr(streaming, "GRID_ROWS", 256)
    kw = dict(M=8, Ks=64, iters=4, refine_M=8, opq="refine", opq_iters=2, train_sample=500,
              builder="device", device="cuda")
    a = build_hnsw_pq(x, **kw).to_arrays()[1]
    assert_same_arrays(a, build_hnsw_pq(x, **kw).to_arrays()[1], atol=0)

    def chunks():
        for s in range(0, len(x), 300):
            yield x[s:s + 300]

    assert_same_arrays(a, build_hnsw_pq(chunks, n=len(x), **kw).to_arrays()[1], atol=0)
