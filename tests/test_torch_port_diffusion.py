"""The port's kNN-graph diffusion (``rerank/diffusion.py``) against the JAX
package's on the same seeded numpy inputs: every stage of the offline build,
both solvers, the online passes, the ranks, and the artifact both ways.

Tolerances: ids equal; scores within 1e-5, relative and absolute (f32
summation order differs between the packages, CG carries such differences
on through its steps, and the scatter-add sums a gallery id's contributions
in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.rerank import diffusion as jd
from image_search_engine_for_historical_research_tpu_torch.rerank import diffusion as td
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
RTOL = 1e-5


def clustered(n=256, d=32, n_centers=8, spread=0.25, seed=0):
    """Unit rows around ``n_centers`` centres (kNN sets well separated)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d))
    x = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def queries(v, nq=6, seed=1):
    rng = np.random.default_rng(seed)
    q = v[rng.choice(v.shape[0], nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, v.shape[1]))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def t(x):
    return torch.as_tensor(np.asarray(x))


def _same_rows(ids_t, ids_j, sc_t=None, sc_j=None, atol=ATOL):
    np.testing.assert_array_equal(np.asarray(ids_t), np.asarray(ids_j))
    if sc_t is not None:
        np.testing.assert_allclose(np.asarray(sc_t, np.float32), np.asarray(sc_j, np.float32),
                                   rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def gallery():
    return clustered()


def test_knn_graph_and_laplacian_stages(gallery):
    kd = 12
    s_j, i_j = jd._knn_graph(jnp.asarray(gallery), kd)
    s_t, i_t = td._knn_graph(t(gallery), kd)
    _same_rows(i_t, i_j, s_t, s_j)

    np.testing.assert_array_equal(td._mutual_mask(i_t, chunk=50).numpy(),
                                  np.asarray(jd._mutual_mask(i_j, chunk=50)))

    nbr_j, val_j = jd._laplacian_rows(jnp.asarray(gallery), kd)
    nbr_t, val_t = td._laplacian_rows(t(gallery), kd)
    _same_rows(nbr_t, nbr_j, val_t, val_j)

    th_j, dinv_j = jd._threshold_laplacian_stats(s_j, i_j)
    th_t, dinv_t = td._threshold_laplacian_stats(s_t, i_t)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dinv_t.numpy(), np.asarray(dinv_j), rtol=1e-5, atol=0)


def test_row_sliced_knn_graph_matches_one_call(gallery, monkeypatch):
    """Above ``KNN_GRAPH_ONECALL_BYTES`` the gallery goes to bf16 and the rows
    are scored in slices: the one-call path's self column everywhere, near
    every neighbour (bf16 may swap near-ties), and JAX's sliced path's ids."""
    v = gallery[:200]                                    # 200 % 64 != 0: a short tail slice
    k = 10
    s_ref, i_ref = td._knn_graph(t(v), k)
    monkeypatch.setattr(td, "KNN_GRAPH_ONECALL_BYTES", 0)
    monkeypatch.setattr(td, "KNN_GRAPH_QROWS", 64)
    s_chk, i_chk = td._knn_graph(t(v), k)
    assert tuple(i_chk.shape) == (200, k)
    np.testing.assert_array_equal(i_chk[:, 0].numpy(), i_ref[:, 0].numpy())
    overlap = np.mean([len(np.intersect1d(a, b)) / k
                       for a, b in zip(i_ref.numpy(), i_chk.numpy())])
    assert overlap >= 0.95
    np.testing.assert_allclose(s_chk.numpy(), s_ref.numpy(), rtol=2e-2, atol=2e-2)

    monkeypatch.setattr(jd, "KNN_GRAPH_ONECALL_BYTES", 0)
    monkeypatch.setattr(jd, "KNN_GRAPH_QROWS", 64)
    s_j, i_j = jd._knn_graph(jnp.asarray(v), k)
    _same_rows(i_chk, i_j, s_chk, s_j)


def same_graph(monkeypatch, vecs, kd):
    """JAX's build takes the port's kNN graph (held against JAX's own in
    ``test_knn_graph_and_laplacian_stages``). The recompute solver tests
    ``G >= thresh`` with G and thresh from two different products, equal in
    exact arithmetic at the kd-th neighbour, so either package may decide
    that edge either way; with one graph both decide it the same way."""
    s, i = td._knn_graph(t(vecs), kd)
    graph = (jnp.asarray(s.numpy()), jnp.asarray(i.numpy().astype(np.int32)))
    monkeypatch.setattr(jd, "_knn_graph", lambda v, k: graph)


@pytest.mark.parametrize("solver", ["tables", "recompute"])
def test_build_offline_matches_jax(gallery, solver, monkeypatch):
    kw = dict(n_trunc=64, kd=12, batch=100, solver=solver, host_out=False)
    same_graph(monkeypatch, gallery, 12)
    off_j = jd.build_diffusion_offline(jnp.asarray(gallery), **kw)
    off_t = td.build_diffusion_offline(t(gallery), **kw)
    assert off_t.trunc_ids.dtype == torch.int32 and off_t.scores.dtype == torch.float32
    assert tuple(off_t.trunc_ids.shape) == (256, 64) and not off_t.on_host
    _same_rows(off_t.trunc_ids, off_j.trunc_ids, off_t.scores, off_j.scores)


def test_batched_cg_freezes_converged_rows():
    """Each system stops on its own: an identity row converges in one step
    and its solution stays exact (a further step would divide 0 by 0), while
    a harder row runs on; batched equals one row at a time."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5, 5)) * 0.2
    A = np.eye(5)[None] + np.einsum("bij,bkj->bik", a, a)
    A[0] = np.eye(5)
    A = torch.as_tensor(A, dtype=torch.float32)
    b = torch.zeros(3, 5)
    b[:, 0] = 1.0

    def mv(mat):
        return lambda v: torch.bmm(mat, v[:, :, None])[:, :, 0]

    x = td._batched_cg(mv(A), b)
    assert torch.isfinite(x).all()
    np.testing.assert_array_equal(x[0].numpy(), b[0].numpy())
    for r in range(3):
        xr = td._batched_cg(mv(A[r:r + 1]), b[r:r + 1])
        np.testing.assert_allclose(x[r:r + 1].numpy(), xr.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(torch.bmm(A, x[:, :, None])[:, :, 0].numpy(), b.numpy(),
                               atol=1e-4)


def test_online_scores_device_and_hosted(gallery):
    q = queries(gallery)
    off_j = jd.build_diffusion_offline(jnp.asarray(gallery), n_trunc=64, kd=12, host_out=False)
    off_t = td.build_diffusion_offline(t(gallery), n_trunc=64, kd=12, host_out=False)
    dense_j = np.asarray(jd.diffusion_online_scores(off_j.trunc_ids, off_j.scores,
                                                    jnp.asarray(gallery), jnp.asarray(q)))
    dense_t = td.diffusion_online_scores(off_t.trunc_ids, off_t.scores, t(gallery), t(q))
    assert dense_t.dtype == torch.float32
    np.testing.assert_allclose(dense_t.numpy(), dense_j, rtol=RTOL, atol=ATOL)

    host_j = jd.build_diffusion_offline(jnp.asarray(gallery), n_trunc=64, kd=12, host_out=True)
    host_t = td.build_diffusion_offline(t(gallery), n_trunc=64, kd=12, host_out=True)
    assert host_t.on_host and host_t.scores.dtype == np.float16
    assert host_t.trunc_ids.dtype == np.int32
    _same_rows(host_t.trunc_ids, host_j.trunc_ids)
    # f16 scores: the two packages may round a score on either side
    np.testing.assert_allclose(host_t.scores.astype(np.float32),
                               host_j.scores.astype(np.float32), rtol=1e-3, atol=1e-4)
    hs_j = np.asarray(jd.diffusion_online_scores_hosted(host_j, jnp.asarray(gallery),
                                                         jnp.asarray(q)))
    hs_t = td.diffusion_online_scores_hosted(host_t, t(gallery), t(q))
    np.testing.assert_allclose(hs_t.numpy(), hs_j, rtol=1e-3, atol=1e-4)
    # the same f16 artifact on both sides: f32 tolerance again
    hs_t2 = td.diffusion_online_scores_hosted(td.DiffusionOffline(host_j.trunc_ids,
                                                                  host_j.scores),
                                              t(gallery), t(q))
    np.testing.assert_allclose(hs_t2.numpy(), hs_j, rtol=RTOL, atol=ATOL)


def _assert_ranks_match(ranks_t, ranks_j, scores, tol=1e-6):
    """Ranks equal wherever neighbouring scores differ by more than ``tol``;
    inside a run of scores within ``tol`` the same ids in any order."""
    ranks_t, ranks_j = np.asarray(ranks_t), np.asarray(ranks_j)
    for r in range(ranks_j.shape[0]):
        s = scores[r][ranks_j[r]]
        start = 0
        for i in range(1, len(s) + 1):
            if i == len(s) or abs(s[i] - s[i - 1]) > tol:
                assert sorted(ranks_t[r, start:i]) == sorted(ranks_j[r, start:i]), (r, start)
                start = i


def test_diffusion_rerank_ranks(gallery):
    q = queries(gallery, nq=8)
    ranks_j, off_j = jd.diffusion_rerank(jnp.asarray(gallery), jnp.asarray(q), n_trunc=96,
                                         kd=12)
    ranks_t, off_t = td.diffusion_rerank(t(gallery), t(q), n_trunc=96, kd=12)
    assert tuple(ranks_t.shape) == (8, 96)
    dense = np.asarray(jd.diffusion_online_scores(off_j.trunc_ids, off_j.scores,
                                                  jnp.asarray(gallery), jnp.asarray(q)))
    _assert_ranks_match(ranks_t, ranks_j, dense)
    # the dense rows hold many exact zeros: the lower id comes first among
    # them, as in lax.top_k
    np.testing.assert_array_equal(ranks_t.numpy(), np.asarray(ranks_j))
    # a given artifact is used as is; a host artifact gives the same ranks
    again, same = td.diffusion_rerank(t(gallery), t(q), offline=off_t, n_trunc=96)
    assert same is off_t
    np.testing.assert_array_equal(again.numpy(), ranks_t.numpy())
    host = td.DiffusionOffline(off_t.trunc_ids.numpy(), off_t.scores.numpy())
    np.testing.assert_array_equal(
        td.diffusion_rerank(t(gallery), t(q), offline=host, n_trunc=96)[0].numpy(),
        ranks_t.numpy())


def test_regime_guard_and_budget():
    class FakeShape:
        shape = (200_000, 8)

    with pytest.raises(ValueError, match="regime"):
        td.build_diffusion_offline(FakeShape())
    with pytest.raises(ValueError, match="solver"):
        td.build_diffusion_offline(t(clustered(n=40)), n_trunc=16, kd=4, solver="bogus")
    with pytest.raises(TypeError, match="DeviceMesh"):
        td.build_diffusion_offline(t(clustered(n=40)), mesh=object())
    for args in [(1_000_000, 2000, 4 << 30, 2), (1_000_000, 2000, 3 << 30, 2),
                 (1000, 2000, 1 << 30, 4), (10_000_000, 2000, 1 << 20, 2)]:
        assert td.budget_trunc_size(*args) == jd.budget_trunc_size(*args)
    assert td.budget_trunc_size(1_000_000, 2000, 3 << 30) == 512


def test_budget_and_defaults_above_regime(monkeypatch):
    """Above the regime (lowered here): recompute solver, host f16 artifact,
    T from the memory budget; the same as JAX's build."""
    v = clustered(n=300, d=16, seed=2)
    monkeypatch.setattr(td, "DIFFUSION_REGIME_MAX", 100)
    monkeypatch.setattr(jd, "DIFFUSION_REGIME_MAX", 100)
    with pytest.raises(ValueError, match="allow_large"):
        td.build_diffusion_offline(t(v))
    budget = 300 * 6 * 130
    stats = {}
    off_t = td.build_diffusion_offline(t(v), kd=8, batch=128, allow_large=True,
                                       memory_budget_bytes=budget, stats=stats)
    same_graph(monkeypatch, v, 8)
    off_j = jd.build_diffusion_offline(jnp.asarray(v), kd=8, batch=128, allow_large=True,
                                       memory_budget_bytes=budget)
    assert stats["solver"] == "recompute" and stats["T"] == 128
    assert set(stats) >= {"knn_s", "sweep_s", "knn"}
    assert off_t.on_host and off_t.scores.dtype == np.float16 and off_t.trunc_ids.shape == (300, 128)
    _same_rows(off_t.trunc_ids, off_j.trunc_ids)
    # f16 scores: the two packages may round a score on either side
    np.testing.assert_allclose(off_t.scores.astype(np.float32),
                               off_j.scores.astype(np.float32), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("host_out", [False, True])
def test_artifact_loads_in_the_other_package(gallery, tmp_path, writer, host_out):
    kw = dict(n_trunc=32, kd=8, host_out=host_out)
    path = str(tmp_path / "off.npz")
    if writer == "jax":
        off = jd.build_diffusion_offline(jnp.asarray(gallery), **kw)
        off.save(path)
        loaded = td.DiffusionOffline.load(path, device="cpu")
        assert not loaded.on_host and loaded.trunc_ids.dtype == torch.int32
        ids, sc = loaded.trunc_ids.numpy(), loaded.scores.numpy()
    else:
        off = td.build_diffusion_offline(t(gallery), **kw)
        off.save(path)
        loaded = jd.DiffusionOffline.load(path, to_device=False)
        ids, sc = loaded.trunc_ids, loaded.scores
        assert td.DiffusionOffline.load(path, to_device=False).on_host
    ref_ids = np.asarray(off.trunc_ids)
    ref_sc = off.scores if isinstance(off.scores, np.ndarray) else np.asarray(off.scores)
    assert ids.dtype == np.int32 and sc.dtype == ref_sc.dtype
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(sc, ref_sc)


def test_load_to_cuda_without_a_gpu_raises(gallery, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    off = td.build_diffusion_offline(t(gallery[:64]), n_trunc=16, kd=4)
    off.save(str(tmp_path / "a.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.DiffusionOffline.load(str(tmp_path / "a.npz"))
