"""The beam search's plain PyTorch version vs the JAX Pallas kernel (interpret
mode), and the CUDA kernel vs the plain version where a GPU is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build
from image_search_engine_for_historical_research_tpu.ops.graph_search import (
    hnsw_descend_entries as j_descend,
)
from image_search_engine_for_historical_research_tpu.ops.pallas_graph import (
    pallas_beam_search,
)
from image_search_engine_for_historical_research_tpu_torch.index import HNSWIndex
from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
from image_search_engine_for_historical_research_tpu_torch.ops.beam_search_cases import (
    DEVICE_VISITED,
    EDGE_CASES,
    NO_CACHE,
    quarter_case,
)
from torch_port_helpers import assert_beams_in_order, assert_same_beams


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(db, nbr0, q, starts, ef):
    want = pallas_beam_search(jnp.asarray(db), jnp.asarray(nbr0), jnp.asarray(q),
                              jnp.asarray(starts), ef=ef, interpret=True)
    got = bs.beam_search(_t(db), _t(nbr0), _t(q), _t(starts), ef=ef)
    return want, got


@pytest.fixture(scope="module")
def graph():
    """N=2000, D=64, Q=8 (the JAX kernel test's case)."""
    rng = np.random.default_rng(0)
    x = _unit(rng.standard_normal((2000, 64)))
    q = _unit(x[rng.integers(0, 2000, 8)] + 0.01 * rng.standard_normal((8, 64)))
    ix = j_build(x, m=8, ef_construction=64)
    starts = np.asarray(j_descend(ix.vectors, ix.nbru, ix.entry, jnp.asarray(q)))
    return ix, q, starts


def test_plain_matches_pallas_n2000(graph):
    ix, q, starts = graph
    launches = bs.launches
    (sj, ij), (st, it) = _both(ix.vectors, ix.nbr0, q, starts, ef=64)  # ef_pad 128
    assert it.shape == (8, 64) and it.dtype == torch.int32
    assert_same_beams(sj, ij, st, it)
    for row in it.numpy():                       # no duplicate ids
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid)
    assert bs.launches == launches               # CPU tensors never launch


@pytest.mark.parametrize("n", [11, 203])
def test_plain_matches_pallas_ragged_n(n):
    rng = np.random.default_rng(3)
    x = _unit(rng.standard_normal((n, 64)))
    q = _unit(x[rng.integers(0, n, 6)] + 0.005 * rng.standard_normal((6, 64)))
    ix = j_build(x, m=8, ef_construction=32)
    starts = np.asarray(j_descend(ix.vectors, ix.nbru, ix.entry, jnp.asarray(q)))
    (sj, ij), (st, it) = _both(ix.vectors, ix.nbr0, q, starts, ef=32)
    assert_same_beams(sj, ij, st, it)
    if n == 11:  # fewer nodes than slots: unfilled slots are id -1, score -3.4e38
        assert (it.numpy()[:, 11:] == -1).all()
        np.testing.assert_array_equal(st.numpy()[:, 11:], -np.float32(3.4e38))


def test_plain_matches_pallas_padding_and_repeats():
    """A neighbour table with -1 padding (which must never mark node 0) and
    ids repeated within one row (fresh only the first time)."""
    rng = np.random.default_rng(7)
    n, m0 = 300, 16
    x = _unit(rng.standard_normal((n, 64)))
    nbr0 = rng.integers(1, n, (n, m0)).astype(np.int32)
    nbr0[:, 9] = nbr0[:, 2]                       # a repeat in every row
    for i in range(n):
        nbr0[i, m0 - rng.integers(0, 6):] = -1    # ragged -1 tail
    nbr0[5, :] = -1                               # a node with no neighbours
    nbr0[17, 0] = 0                               # node 0 reachable only from 17
    q = _unit(rng.standard_normal((5, 64)))
    starts = np.array([5, 17, 42, 0, 299], np.int32)
    (sj, ij), (st, it) = _both(x, nbr0, q, starts, ef=32)
    assert_same_beams(sj, ij, st, it)


def test_plain_matches_pallas_duplicate_rows():
    """Exact distance ties (rows drawn from 20 distinct ones, values k/4): the
    first-index rules of the insert and the pop decide, id for id."""
    db, nbr0, q, starts = quarter_case(11, 300, 64, 16, 6, dup=20)
    (sj, ij), (st, it) = _both(db, nbr0, q, starts, ef=32)
    assert_beams_in_order(sj, ij, st, it)


def test_ef_limit():
    """ef pads to 128-slot multiples; past the kernel's register beam it is
    refused before anything launches (the CPU path has no such limit)."""
    assert bs.check_ef(100) == 128 and bs.check_ef(bs.MAX_EF_PAD) == bs.MAX_EF_PAD
    for ef in (0, bs.MAX_EF_PAD + 1):
        with pytest.raises(ValueError, match="ef"):
            bs.check_ef(ef)


def test_plain_matches_pallas_reach():
    """``reach`` confines the neighbours and starts to that many nodes spread
    over N (the device-bitset edge cases' graphs), and leaves the draws of
    the other arrays as they were."""
    db, nbr0, q, starts = quarter_case(13, 3000, 64, 16, 4, reach=120)
    db0, nbr00, q0, _ = quarter_case(13, 3000, 64, 16, 4)
    np.testing.assert_array_equal(db, db0)
    np.testing.assert_array_equal(q, q0)
    np.testing.assert_array_equal(nbr0 < 0, nbr00 < 0)
    pool = np.unique(nbr0[nbr0 >= 0])
    assert len(pool) <= 120 and pool.max() > 2000 and np.isin(starts, pool).all()
    (sj, ij), (st, it) = _both(db, nbr0, q, starts, ef=128)
    assert_beams_in_order(sj, ij, st, it)
    assert np.isin(it.numpy()[it.numpy() >= 0], pool).all()


@pytest.mark.parametrize("Q, N, smem_visited, want", [
    (70, 1_000_000, 1, 70),                # bitset in shared memory: one launch
    (0, 1_000_000, 1, 1),
    (70, 1_787_777, 0, 70),                # 1 GiB holds 4,804 bitsets of 1.79M
    (10_000, 1_787_777, 0, 4_804),
    (5, 2 ** 33, 0, 1),                    # one bitset above the budget: one a launch
])
def test_query_chunk(Q, N, smem_visited, want):
    assert bs.query_chunk(Q, N, smem_visited) == want


def test_phase_clocks_need_the_card():
    db, nbr0, q, starts = (_t(a) for a in quarter_case(0, 50, 8, 8, 2))
    launches = bs.launches
    with pytest.raises(ValueError, match="only on the card"):
        bs.beam_search_phase_clocks(db, nbr0, q, starts, ef=16)
    assert bs.launches == launches


def test_multi_seed_matches_pallas(graph):
    ix, q, _ = graph
    assert ix.coarse_ids is not None and ix.coarse_ids.shape[0] >= 3
    sj, ij = ix.search_pallas(jnp.asarray(q), 10, ef=32, interpret=True, n_seeds=3)
    meta, arrays = ix.to_arrays()
    tix = HNSWIndex.from_arrays(meta, arrays, device="cpu")
    st, it = tix.search_kernel(q, 10, ef=32, n_seeds=3)
    assert_same_beams(sj, ij, st, it)
    for row in it.numpy():
        assert len(set(row.tolist())) == len(row)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """On the card: the kernel against the plain version (f32 and bf16 db)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, d, m0, Q = 5000, 256, 32, 16
    db = torch.randn(n, d, generator=g, device="cuda")
    db /= db.norm(dim=1, keepdim=True)
    nbr0 = torch.randint(0, n, (n, m0), generator=g, device="cuda", dtype=torch.int32)
    nbr0[:, 20:] = -1
    nbr0[:, 7] = nbr0[:, 3]
    q = torch.randn(Q, d, generator=g, device="cuda")
    starts = torch.randint(0, n, (Q,), generator=g, device="cuda", dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        dbt = db.to(dtype).contiguous()
        before = bs.launches
        s, i = bs.beam_search(dbt, nbr0, q, starts, ef=100)
        torch.cuda.synchronize()
        assert bs.launches == before + 1
        s2, i2 = bs.beam_search_reference(dbt, nbr0, q, starts, ef=100)
        assert_same_beams(s2.cpu(), i2.cpu(), s.cpu(), i.cpu(), atol=1e-3, tie=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cuda_kernel_edge_cases(name):
    """On the card, on exact (quarter-valued) data: the kernel and its phase
    clock build give the plain version's beams id for id, in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    args, kw, ef, dtype = EDGE_CASES[name]
    db, nbr0, q, starts = quarter_case(*args, **kw)
    db = torch.from_numpy(db).cuda().to(getattr(torch, dtype)).contiguous()
    nbr0, q, starts = (torch.from_numpy(a).cuda() for a in (nbr0, q, starts))
    cache, smem_visited, _ = bs.shared_memory_plan(*db.shape, nbr0.shape[1], bs.padded_ef(ef))
    assert bool(cache) == (name not in NO_CACHE)
    assert bool(smem_visited) == (name not in DEVICE_VISITED)
    before = bs.launches
    s, i = bs.beam_search(db, nbr0, q, starts, ef=ef)
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    s2, i2 = bs.beam_search_reference(db, nbr0, q, starts, ef=ef)
    assert_beams_in_order(s2.cpu(), i2.cpu(), s.cpu(), i.cpu())
    s3, i3, clocks = bs.beam_search_phase_clocks(db, nbr0, q, starts, ef=ef)
    assert bs.launches == before + 1
    assert_beams_in_order(s2.cpu(), i2.cpu(), s3.cpu(), i3.cpu())
    hops = clocks[:, bs.CLOCK_SLOTS.index("hops")].cpu()
    assert (hops >= 1).all() and (hops <= 4 * ef).all()


@pytest.mark.cuda
def test_cuda_kernel_limits():
    """On the card: ef above the register beam raises, naming the limit; an
    N that fits only without the neighbour-row cache launches without it; an
    N whose visited bitset does not fit in shared memory keeps it in device
    memory, with the cache where that fits and without it at ef_pad 2048."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    d = 8
    db = torch.zeros(1000, d, device="cuda")
    nbr0 = torch.full((1000, 32), -1, dtype=torch.int32, device="cuda")
    q = torch.zeros(1, d, device="cuda")
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 2048"):
        bs.beam_search(db, nbr0, q, starts, ef=2100)
    assert bs.shared_memory_plan(1_000_000, d, 32, 128)[:2] == (1, 1)
    assert bs.shared_memory_plan(1_700_000, d, 32, 128)[:2] == (0, 1)
    assert bs.shared_memory_plan(4_000_000, d, 32, 128)[:2] == (1, 0)
    assert bs.shared_memory_plan(4_000_000, d, 32, 2048)[:2] == (0, 0)
    assert bs.shared_memory_plan(1_787_776, 2048, 32, 128)[1] == 1
    assert bs.shared_memory_plan(1_787_777, 2048, 32, 128)[:2] == (1, 0)


@pytest.mark.cuda
def test_cuda_device_bitset_query_chunks(monkeypatch):
    """On the card, with the bitset in device memory: a budget of one query's
    bitset launches once a query, and the beams equal one launch's and the
    plain version's, in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    args, kw, ef, _ = EDGE_CASES["visited_in_device_memory"]
    db, nbr0, q, starts = (torch.from_numpy(a).cuda() for a in quarter_case(*args, **kw))
    s1, i1 = bs.beam_search(db, nbr0, q, starts, ef=ef)
    monkeypatch.setattr(bs, "VISITED_BYTES", 4 * ((db.shape[0] + 31) // 32))
    before = bs.launches
    s, i = bs.beam_search(db, nbr0, q, starts, ef=ef)
    torch.cuda.synchronize()
    assert bs.launches == before + q.shape[0]
    assert torch.equal(i, i1) and torch.equal(s, s1)
    s2, i2 = bs.beam_search_reference(db, nbr0, q, starts, ef=ef)
    assert_beams_in_order(s2.cpu(), i2.cpu(), s.cpu(), i.cpu())
