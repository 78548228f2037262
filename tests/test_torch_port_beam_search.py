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
from torch_port_helpers import assert_same_beams


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
