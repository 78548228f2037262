"""The port's sharded builds (``parallel``, ``mesh=``) in a gloo world of 2
on the CPU, held against the port's unsharded builds and against the JAX
package's builds on the 8-device virtual CPU mesh of ``tests/conftest.py``.

One module fixture spawns the world once (``tests/torch_port_parallel_worker.py``,
a ``file://`` rendezvous, one torch thread a rank); each rank runs every case
and writes its results. Sizes divide 8, so both packages take their sharded
branches. JAX's draws are substituted at the port's seams where they can be
(the k-means initial centres, the RP-forest level draws); the tolerances are
JAX's own ``tests/test_parallel.py``'s.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu import parallel as jparallel
from image_search_engine_for_historical_research_tpu.index import build_ivfpq as j_build_ivfpq
from image_search_engine_for_historical_research_tpu.index import build_pq as j_build_pq
from image_search_engine_for_historical_research_tpu.index import (
    build_rpforest as j_build_rpforest,
)
from image_search_engine_for_historical_research_tpu.index import graph_build as jgb
from image_search_engine_for_historical_research_tpu.ops import kmeans as jkm
from image_search_engine_for_historical_research_tpu.ops import pq as jpq
from image_search_engine_for_historical_research_tpu.rerank import (
    build_diffusion_offline as j_build_diffusion,
)
from image_search_engine_for_historical_research_tpu_torch.index import (
    build_hnsw_device,
    build_ivfpq,
    build_pq,
    build_rpforest,
)
from image_search_engine_for_historical_research_tpu_torch.index import rpforest as trp
from image_search_engine_for_historical_research_tpu_torch.index.graph_build import (
    build_knn_graph,
)
from image_search_engine_for_historical_research_tpu_torch.ops import kmeans as tkm
from image_search_engine_for_historical_research_tpu_torch.ops import pq as tpq
from image_search_engine_for_historical_research_tpu_torch.ops.topk import exact_topk
from image_search_engine_for_historical_research_tpu_torch.rerank import build_diffusion_offline
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_ranks,
    jax_forest_draws,
    one_torch_thread,
)
import torch_port_parallel_worker as worker

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2


def clustered(seed, n_clusters, views, D, noise=0.1):
    """``tests/test_parallel.py``'s data: tight unit-norm clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, D)).astype(np.float32)
    x = (centers[:, None] + noise * rng.standard_normal((n_clusters, views, D))).reshape(
        -1, D).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def jax_subspace_inits(x, M, Ks, seed):
    """JAX ``pq_train``'s initial centres of each subspace, ``(M, Ks, ds)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    ds = x.shape[1] // M
    return np.stack([np.asarray(jkm._init_centers(jnp.asarray(x[:, m * ds:(m + 1) * ds]), Ks,
                                                  keys[m], "kmeans++")) for m in range(M)])


def make_inputs():
    rng = np.random.default_rng(0)
    inp = {}
    db = rng.standard_normal((1024, 64)).astype(np.float32)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    inp["topk_db"] = db / np.linalg.norm(db, axis=1, keepdims=True)
    inp["topk_q"] = q / np.linalg.norm(q, axis=1, keepdims=True)
    inp["topk_db2"] = rng.standard_normal((64, 16)).astype(np.float32)  # 32 rows a rank
    inp["topk_q2"] = rng.standard_normal((3, 16)).astype(np.float32)
    inp["topk_k2"] = np.array(40)
    inp["kmeans_x"] = clustered(2, 8, 128, 16)
    inp["kmeans_init"] = np.asarray(jkm._init_centers(
        jnp.asarray(inp["kmeans_x"]), 8, jax.random.PRNGKey(3), "kmeans++"))[None]
    inp["kmeans_init_rows"] = np.array(1024)
    inp["pq_x"] = clustered(3, 8, 64, 32)
    inp["pq_init"] = jax_subspace_inits(inp["pq_x"], 4, 8, 42)
    inp["pq_init_rows"] = np.array(512)
    fit_rows = inp["pq_x"][tpq.train_indices(512, 256, 42)]
    inp["stream_init"] = jax_subspace_inits(fit_rows, 4, 8, 42)
    inp["stream_init_rows"] = np.array(256)
    inp["graph_x"] = clustered(4, 8, 64, 32)
    inp["graph_q"] = inp["graph_x"][::37] + 0.02 * rng.standard_normal((14, 32)).astype(
        np.float32)
    inp["diff_x"] = clustered(5, 8, 32, 16)
    rng5 = np.random.default_rng(5)
    centers = rng5.standard_normal((8, 32)).astype(np.float32) * 5
    inp["ivf_x"] = (centers[rng5.integers(0, 8, 512)]
                    + rng5.standard_normal((512, 32)).astype(np.float32) * 0.05)
    inp["forest_x"] = np.random.default_rng(7).standard_normal((256, 32)).astype(np.float32)
    depth = 3                                         # ceil(log2(256 / 32))
    for tree in range(worker.FOREST_KW["n_trees"]):
        for level in range(depth):
            draws = jax_forest_draws(3, worker.FOREST_KW["n_trees"], tree, level, 256,
                                     1 << level, 32)
            for i, a in enumerate(draws):
                inp[f"forest_draw_{tree}_{level}_{i}"] = a.numpy()
    return inp


class World:
    """The spawned ranks; ``result(rank)`` waits for them once."""

    def __init__(self, directory, inputs):
        self.inputs = inputs
        np.savez(directory / "inputs.npz", **inputs)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.outs = [directory / f"rank{r}.npz" for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_port_parallel_worker.py"), str(r),
             str(WORLD), str(directory / "rendezvous"), str(directory / "inputs.npz"),
             str(self.outs[r])], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(WORLD)]
        self._results = None

    def result(self, rank=0):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    out, err = p.communicate(timeout=300)
                    logs.append(f"rc {p.returncode}\n{out[-2000:]}\n{err[-4000:]}")
            finally:
                self.close()
            assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)
            self._results = [dict(np.load(o)) for o in self.outs]
        return self._results[rank]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("world2"), make_inputs())
    yield w
    w.close()


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.data_mesh(8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_every_rank_returns_the_same_result(world):
    r0, r1 = world.result(0), world.result(1)
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)


def test_sharded_topk_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    s, i = exact_topk(t(inp["topk_q"]), t(inp["topk_db"]), 17)
    np.testing.assert_array_equal(got["topk_i"], i.numpy())
    np.testing.assert_allclose(got["topk_s"], s.numpy(), atol=1e-6)
    js, ji = jparallel.sharded_exact_topk(
        jnp.asarray(inp["topk_q"]), jparallel.shard_batch(jnp.asarray(inp["topk_db"]), jmesh),
        17, jmesh, chunk=128)
    np.testing.assert_array_equal(got["topk_i"], np.asarray(ji))
    np.testing.assert_allclose(got["topk_s"], np.asarray(js), atol=1e-6)


def test_sharded_topk_k_exceeds_shard(world, jmesh):
    """k=40 above a rank's 32 rows: the merge still gives the exact top-40.
    JAX's 8 shards of 8 rows guarantee only its top-8."""
    inp, got = world.inputs, world.result()
    k = int(inp["topk_k2"])
    s, i = exact_topk(t(inp["topk_q2"]), t(inp["topk_db2"]), k)
    assert got["topk2_i"].shape == (3, k)
    np.testing.assert_array_equal(got["topk2_i"], i.numpy())
    np.testing.assert_allclose(got["topk2_s"], s.numpy(), atol=1e-6)
    ref = np.argsort(-(inp["topk_q2"] @ inp["topk_db2"].T), axis=1)[:, :k]
    np.testing.assert_array_equal(got["topk2_i"], ref)
    js, ji = jparallel.sharded_exact_topk(
        jnp.asarray(inp["topk_q2"]), jparallel.shard_batch(jnp.asarray(inp["topk_db2"]), jmesh),
        k, jmesh, chunk=128)
    np.testing.assert_array_equal(got["topk2_i"][:, :8], np.asarray(ji)[:, :8])
    np.testing.assert_allclose(got["topk2_s"][:, :8], np.asarray(js)[:, :8], atol=1e-6)


def test_indivisible_rows_raise(world, jmesh):
    """Rows that do not divide the mesh raise ``ValueError`` naming it, in
    the top-k, ``shard_batch`` and the sharded k-means, as in JAX."""
    assert world.result()["indivisible_raised"].tolist() == [True, True, True]
    with pytest.raises(ValueError, match="divisible"):
        jparallel.sharded_exact_topk(jnp.zeros((1, 4)), jnp.zeros((10, 4)), 2, jmesh)


def test_sharded_kmeans_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    with worker.table_inits(inp, "kmeans_init"):
        c, a = tkm.kmeans_fit(t(inp["kmeans_x"]), 8, iters=10)
    jc, ja = jkm.kmeans_fit_sharded(jnp.asarray(inp["kmeans_x"]), 8, jmesh, iters=10,
                                    key=jax.random.PRNGKey(3))
    for ref_c, ref_a in ((c.numpy(), a.numpy()), (np.asarray(jc), np.asarray(ja))):
        np.testing.assert_allclose(got["kmeans_c"], ref_c, atol=1e-4)
        assert np.mean(got["kmeans_a"] == ref_a) >= 0.999


def test_sharded_pq_fit_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    with worker.table_inits(inp, "pq_init"):
        ix = build_pq(inp["pq_x"], **worker.PQ_KW)
    jix = j_build_pq(inp["pq_x"], M=4, Ks=8, iters=8, normalize=False, mesh=jmesh)
    for cw, codes in ((ix.codewords.numpy(), ix.codes.long().numpy()),
                      (np.asarray(jix.codewords), np.asarray(jix.codes))):
        np.testing.assert_allclose(got["pq_codewords"], cw, atol=1e-4)
        assert np.mean(got["pq_codes"] == codes) >= 0.99


def test_sharded_opq_fit_matches_unsharded_and_jax(world, jmesh):
    """The rotation is not elementwise stable across reduction orders
    (JAX's own test says so): it must be orthogonal, and the sharded
    build's quantization error within 5% of the unsharded port's and of
    JAX's mesh build's."""
    inp, got = world.inputs, world.result()
    x = inp["pq_x"]
    R = got["opq_rotation"]
    np.testing.assert_allclose(R @ R.T, np.eye(R.shape[0]), atol=1e-5)

    def qerr(rec):
        return float(np.mean(np.sum((rec - x) ** 2, axis=1)))

    cb = tpq.PQCodebook(codewords=t(got["opq_codewords"]), rotation=t(R))
    e_sharded = qerr(tpq.pq_decode(cb, tpq.pq_encode(cb, t(x))).numpy())
    ix = build_pq(x, **worker.OPQ_KW)
    e_port = qerr(tpq.pq_decode(ix.codebook, tpq.pq_encode(ix.codebook, t(x))).numpy())
    jix = j_build_pq(x, M=4, Ks=8, iters=8, normalize=False, opq=True, opq_iters=3, mesh=jmesh)
    e_jax = qerr(np.asarray(jpq.pq_decode(jix.codebook, jpq.pq_encode(jix.codebook,
                                                                       jnp.asarray(x)))))
    assert e_sharded <= e_port * 1.05 + 1e-6, (e_sharded, e_port)
    assert e_sharded <= e_jax * 1.05 + 1e-6, (e_sharded, e_jax)


def test_sharded_streaming_build_pq(world, jmesh):
    """A streamed ``build_pq(mesh=)`` equals the in-memory one on every rank;
    its coarse codebook matches the unsharded streamed build and JAX's
    streamed mesh build from the same initial centres."""
    inp, got = world.inputs, world.result()
    x = inp["pq_x"]
    assert got["stream_equals_memory"].all()
    kw = dict(worker.PQ_KW, train_sample=256, refine_M=4)
    with worker.table_inits(inp, "stream_init"):
        ix = build_pq(lambda: (x[s:s + 100] for s in range(0, len(x), 100)), n=len(x), **kw)
    jix = j_build_pq(lambda: (x[s:s + 100] for s in range(0, len(x), 100)), n=len(x), M=4,
                     Ks=8, iters=8, normalize=False, train_sample=256, refine_M=4, mesh=jmesh)
    for cw, codes in ((ix.codewords.numpy(), ix.codes.long().numpy()),
                      (np.asarray(jix.codewords), np.asarray(jix.codes))):
        np.testing.assert_allclose(got["stream_codewords"], cw, atol=1e-4)
        assert np.mean(got["stream_codes"] == codes) >= 0.99


def test_sharded_knn_graph_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    g = t(inp["graph_x"]).to(torch.bfloat16)
    ids, sc = build_knn_graph(g, 16, batch=128)
    np.testing.assert_array_equal(got["knn_ids"], ids.numpy())
    np.testing.assert_allclose(got["knn_sc"], sc.numpy(), atol=1e-6)
    jids, jsc = jgb.build_knn_graph(jnp.asarray(inp["graph_x"]).astype(jnp.bfloat16), 16,
                                    batch=128, mesh=jmesh)
    # against JAX, ids by score: bf16 products summed in another order may
    # swap two rows whose scores tie to the last bit
    assert_same_ranks(np.asarray(jsc), np.asarray(jids), got["knn_sc"], got["knn_ids"], tie=1e-6)


def test_sharded_hnsw_build_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    ix = build_hnsw_device(inp["graph_x"], **worker.GRAPH_KW)
    jix = jgb.build_hnsw_tpu(inp["graph_x"], m=8, k_candidates=16, batch=128, normalize=False,
                             mesh=jmesh)
    for nbr0, nbru, entry in ((ix.nbr0.numpy(), ix.nbru.numpy(), ix.entry),
                              (np.asarray(jix.nbr0), np.asarray(jix.nbru), jix.entry)):
        np.testing.assert_array_equal(got["hnsw_nbr0"], nbr0)
        np.testing.assert_array_equal(got["hnsw_nbru"], nbru)
        assert int(got["hnsw_entry"]) == entry
    np.testing.assert_array_equal(got["hnsw_search"],
                                  ix.search(t(inp["graph_q"]), 10, ef=64)[1].numpy())


def test_sharded_diffusion_build_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    off = build_diffusion_offline(t(inp["diff_x"]), **worker.DIFF_KW)
    joff = j_build_diffusion(jnp.asarray(inp["diff_x"]), mesh=jmesh, **worker.DIFF_KW)
    for ids, scores in ((off.trunc_ids.numpy(), off.scores.numpy()),
                        (np.asarray(joff.trunc_ids), np.asarray(joff.scores))):
        np.testing.assert_array_equal(got["diff_ids"], ids)
        np.testing.assert_allclose(got["diff_scores"], scores, atol=1e-4)


def test_sharded_ivfpq_build_matches_unsharded_and_jax(world, jmesh):
    inp, got = world.inputs, world.result()
    q = inp["ivf_x"][:16]
    ix = build_ivfpq(inp["ivf_x"], **worker.IVF_KW)
    jix = j_build_ivfpq(inp["ivf_x"], nlist=8, M=4, Ks=16, nprobe=4, train_fraction=0.5,
                        mesh=jmesh)
    np.testing.assert_array_equal(got["ivf_ids"][:, 0], ix.search(t(q), 5)[1].numpy()[:, 0])
    np.testing.assert_array_equal(got["ivf_ids"][:, 0],
                                  np.asarray(jix.search(jnp.asarray(q), 5)[1])[:, 0])


def test_sharded_rpforest_build_matches_unsharded_and_jax(world, jmesh, monkeypatch):
    """9 trees over 2 ranks: rank 1 builds a copy of tree 0 as padding; JAX
    pads its 8 shards to 16 trees the same way."""
    inp, got = world.inputs, world.result()
    monkeypatch.setattr(trp, "_level_draws", jax_forest_draws)
    ix = build_rpforest(inp["forest_x"], **worker.FOREST_KW)
    jix = j_build_rpforest(inp["forest_x"], n_trees=9, leaf_size=32, seed=3, normalize=False,
                           mesh=jmesh)
    # thresholds: rtol 1e-5 (JAX's sharded-vs-single tolerance), and against
    # JAX's projections atol 1e-6 as well (tests/test_torch_port_rpforest.py)
    for (items, thr), atol in (((ix.leaf_items.numpy(), ix.thresholds.numpy()), 0.0),
                               ((np.asarray(jix.leaf_items), np.asarray(jix.thresholds)), 1e-6)):
        np.testing.assert_array_equal(got["forest_leaf_items"], items)
        np.testing.assert_allclose(got["forest_thresholds"], thr, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(got["forest_planes"], ix.planes.float().numpy())
