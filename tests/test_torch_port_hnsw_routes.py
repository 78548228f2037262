"""How the port's ``HNSWIndex`` chooses its entry points and its route, against
the JAX package: tied coarse rows choose ``lax.top_k``'s start nodes (JAX
``search_pallas`` in interpret mode); ``search`` takes the beam kernel's
wrapper at every N, never the lockstep traversal, and a kernel that fails
raises. The ``cuda`` cases run the same on the card, at N = 1,787,777, one
row above the largest N whose visited bitset fits in shared memory."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build
from image_search_engine_for_historical_research_tpu.ops import pallas_graph as jpg
from image_search_engine_for_historical_research_tpu_torch.index import HNSWIndex
from image_search_engine_for_historical_research_tpu_torch.index import hnsw as t_hnsw
from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
from torch_port_helpers import assert_same_beams

N_LIMIT = 1_787_776      # the largest N whose bitset fits in shared memory at D=2048, m0=32, ef=100


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def tied():
    """A JAX HNSW index whose coarse (upper-level) nodes all hold the same
    row, so every query's coarse scores tie exactly."""
    rng = np.random.default_rng(1)
    jix = j_build(_unit(rng.standard_normal((300, 16))), m=4, ef_construction=16)
    coarse = np.asarray(jix.coarse_ids)
    v = np.array(jix.vectors)
    v[coarse] = v[coarse[0]]
    jix = dataclasses.replace(jix, vectors=jnp.asarray(v))
    q = _unit(rng.standard_normal((6, 16)))
    return jix, q


@pytest.fixture(scope="module")
def plain():
    """A JAX HNSW index without tied rows (the lockstep traversals of the two
    packages meet exact distance ties in no fixed order)."""
    rng = np.random.default_rng(2)
    jix = j_build(_unit(rng.standard_normal((300, 16))), m=4, ef_construction=16)
    return jix, _unit(rng.standard_normal((6, 16)))


def _port(jix, device="cpu"):
    return HNSWIndex.from_arrays(*jix.to_arrays(), device=device)


def _spy(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def spy(db, nbr0, q, starts, **kw):
        seen.append(np.asarray(starts.cpu() if torch.is_tensor(starts) else starts))
        return fn(db, nbr0, q, starts, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("n_seeds", [1, 3])
def test_tied_coarse_rows_start_where_jax_starts(tied, monkeypatch, n_seeds):
    jix, q = tied
    assert jix.coarse_ids.shape[0] > 10
    j_starts, t_starts = [], []
    _spy(monkeypatch, jpg, "pallas_beam_search", j_starts)
    _spy(monkeypatch, bs, "beam_search", t_starts)
    sj, ij = jix.search_pallas(jnp.asarray(q), 10, ef=32, interpret=True, n_seeds=n_seeds)
    st, it = _port(jix).search_kernel(q, 10, ef=32, n_seeds=n_seeds)
    np.testing.assert_array_equal(t_starts[0], j_starts[0])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_search_stays_on_the_kernel_route(plain, monkeypatch):
    """``search`` goes through the kernel's wrapper, never the lockstep
    traversal, and gives JAX ``search_pallas``'s beams."""
    jix, q = plain

    def lockstep(*args, **kwargs):
        raise AssertionError("search took the lockstep traversal")

    monkeypatch.setattr(t_hnsw, "hnsw_search_batch", lockstep)
    seen = []
    _spy(monkeypatch, bs, "beam_search", seen)
    tix = _port(jix)
    st, it = tix.search(q, 10)
    assert len(seen) == 1
    sj, ij = jix.search_pallas(jnp.asarray(q), 10, ef=max(tix.ef_default, 10), interpret=True)
    assert_same_beams(sj, ij, st, it)


def test_kernel_failure_still_raises(plain, monkeypatch):
    """No fallback on error."""
    jix, q = plain

    def broken(*args, **kwargs):
        raise RuntimeError("beam_search kernel launch failed")

    monkeypatch.setattr(bs, "beam_search", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        _port(jix).search(q, 10)


@pytest.mark.cuda
def test_cuda_tied_coarse_rows(tied):
    """On the card: the tied coarse rows give the CPU's start nodes and
    beams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    jix, q = tied
    for n_seeds in (1, 3):
        st, it = _port(jix).search_kernel(q, 10, ef=32, n_seeds=n_seeds)
        sg, ig = _port(jix, "cuda").search_kernel(q, 10, ef=32, n_seeds=n_seeds)
        assert_same_beams(st, it, sg.cpu(), ig.cpu(), atol=1e-4, tie=1e-5)


@pytest.mark.cuda
def test_cuda_above_the_shared_bitset_limit_stays_on_the_kernel(monkeypatch):
    """On the card, a random m0=32 table of N_LIMIT + 1 bf16 rows (7.3 GB):
    the search launches the kernel once, with the visited bitset in device
    memory; the kernel's beams from the same starts equal the plain
    version's, and the search returns their first ``k``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, d = N_LIMIT + 1, 2048
    g = torch.Generator(device="cuda").manual_seed(0)
    vecs = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    for s in range(0, n, 262144):
        blk = torch.randn((min(262144, n - s), d), device="cuda", generator=g)
        vecs[s:s + blk.shape[0]] = blk / blk.norm(dim=1, keepdim=True)
    nbr0 = torch.randint(0, n - 1, (n, 32), device="cuda", dtype=torch.int32, generator=g)
    nbru = torch.full((5, n, 16), -1, dtype=torch.int32, device="cuda")
    coarse = torch.arange(0, n - 1, 4096, dtype=torch.int32, device="cuda")
    q = vecs[:4].float()
    assert bs.shared_memory_plan(n, d, 32, 128)[:2] == (1, 0)
    big = HNSWIndex(vecs, nbr0, nbru, 0, 100, coarse)
    seen = []
    _spy(monkeypatch, bs, "beam_search", seen)
    launches = bs.launches
    s, i = big.search(q, 10)
    torch.cuda.synchronize()
    assert bs.launches == launches + 1
    starts = torch.as_tensor(seen[0], device="cuda")
    sk, ik = bs.beam_search(vecs, nbr0, q, starts, ef=100)
    assert torch.equal(ik[:, :10], i)
    s2, i2 = bs.beam_search_reference(vecs, nbr0, q, starts, ef=100)
    assert_same_beams(s2.cpu(), i2.cpu(), sk.cpu(), ik.cpu(), atol=1e-3, tie=1e-3)
