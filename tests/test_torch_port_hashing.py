"""``ops.hashing`` and the hashing and PQ_Net matchers of the port against the
JAX package: ``pack_bits``, ``_popcount``, ``lsh_encode`` with JAX's planes,
``hamming_topk`` on inputs full of ties (one pass and chunked), the
fractional distance (1e-5, ids but at ties), the flat codeword layout, and
the ``LSH``, ``Greedyhash``, ``fractional``, ``PQ_Net`` and
``PQ_Net_bucket`` matchers; on the card, the Hamming scan's ids equal the
CPU's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import matchers as jm
from image_search_engine_for_historical_research_tpu.ops import hashing as jh
from image_search_engine_for_historical_research_tpu.ops import kmeans as jkm
from image_search_engine_for_historical_research_tpu.ops import softpq as jsoft
from image_search_engine_for_historical_research_tpu_torch.index import matchers as tm
from image_search_engine_for_historical_research_tpu_torch.ops import hashing as th
from image_search_engine_for_historical_research_tpu_torch.ops import kmeans as tkm
from image_search_engine_for_historical_research_tpu_torch.ops import softpq as tsoft
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_ranks,
    clustered_rows,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _codes(n, w, seed, n_distinct=12):
    """Packed codes drawn from a few distinct rows: Hamming ties everywhere."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 2 ** 32, (n_distinct, w), dtype=np.uint64).astype(np.uint32)
    return distinct[rng.integers(0, n_distinct, n)]


def test_pack_bits_and_popcount_match_jax():
    rng = np.random.default_rng(0)
    for B in (32, 70, 512):
        bits = rng.random((9, B)) > 0.5
        want = np.asarray(jh.pack_bits(jnp.asarray(bits)))
        got = th.pack_bits(torch.from_numpy(bits))
        assert got.dtype == torch.uint32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    words = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    want = np.asarray(jh._popcount(jnp.asarray(words)))
    got = th._popcount(th._words(torch.from_numpy(words)).clone())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_lsh_encode_with_jax_planes():
    x = clustered_rows(300, 48, 6, 0.3, seed=1)
    planes = np.array(jh.lsh_hyperplanes(48, 100, seed=3))
    want = np.asarray(jh.lsh_encode(jnp.asarray(planes), jnp.asarray(x)))
    got = th.lsh_encode(torch.from_numpy(planes), torch.from_numpy(x), chunk=128)
    np.testing.assert_array_equal(got.numpy(), want)
    own = th.lsh_hyperplanes(48, 100, seed=3, device="cpu")
    assert own.shape == (100, 48) and torch.equal(own, th.lsh_hyperplanes(48, 100, 3, "cpu"))


@pytest.mark.parametrize("budget", [None, 3000])
def test_hamming_topk_matches_jax_on_ties(monkeypatch, budget):
    """Ids and scores exactly, with many equal distances; ``budget`` shrinks
    the scan's byte budget so queries and gallery go in chunks."""
    db = _codes(400, 3, 2)
    q = _codes(11, 3, 3)
    sj, ij = jh.hamming_topk(jnp.asarray(db), jnp.asarray(q), 25)
    if budget:
        monkeypatch.setattr(th, "SCAN_BYTES", budget)
    st, it = th.hamming_topk(torch.from_numpy(db), torch.from_numpy(q), 25)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st.dtype == torch.float32


@pytest.mark.parametrize("budget", [None, 40_000])
def test_fractional_topk_matches_jax(monkeypatch, budget):
    x = clustered_rows(500, 32, 8, 0.3, seed=4)
    q = x[:7] + 0.05
    sj, ij = jh.fractional_topk(jnp.asarray(x), jnp.asarray(q), 30, 0.5)
    if budget:
        monkeypatch.setattr(th, "SCAN_BYTES", budget)
    st, it = th.fractional_topk(torch.from_numpy(x), torch.from_numpy(q), 30, 0.5)
    assert_same_ranks(sj, ij, st, it, tie=1e-5)


def test_codewords_flat_layout_matches_jax():
    cw = np.random.default_rng(5).standard_normal((4, 16, 6)).astype(np.float32)
    flat = np.asarray(jsoft.codewords_flat(jsoft.SoftPQState(jnp.asarray(cw))))
    np.testing.assert_array_equal(tsoft.codewords_flat(torch.from_numpy(cw)).numpy(), flat)
    np.testing.assert_array_equal(tsoft.codewords_from_flat(torch.from_numpy(flat), 4).numpy(),
                                  np.asarray(jsoft.codewords_from_flat(jnp.asarray(flat), 4)))


def test_matching_lsh_matches_jax(monkeypatch):
    """With JAX's hyperplanes substituted at the port's ``lsh_hyperplanes``."""
    def jax_planes(dim, n_bits, seed=42, device="cuda"):
        return torch.from_numpy(np.array(jh.lsh_hyperplanes(dim, n_bits, seed)))

    monkeypatch.setattr(th, "lsh_hyperplanes", jax_planes)
    x = clustered_rows(350, 64, 10, 0.4, seed=6)
    q = x[::40] + 0.02
    ij, _ = jm.matching_LSH(12, x, q, n_bits=40)
    it, tpq = tm.matching_LSH(12, x, q, n_bits=40, device="cpu")
    assert it.dtype == np.int64 and tpq > 0
    np.testing.assert_array_equal(it, ij)


def test_matching_greedyhash_and_fractional_match_jax():
    rng = np.random.default_rng(7)
    codes = rng.standard_normal((300, 48)).astype(np.float32)
    codes[200:] = codes[:100]
    qcodes = codes[::30] + 0.1 * rng.standard_normal((10, 48)).astype(np.float32)
    ij, _ = jm.matching_Greedyhash(20, codes, qcodes)
    it, _ = tm.matching_Greedyhash(20, codes, qcodes, device="cpu")
    np.testing.assert_array_equal(it, ij)

    x = clustered_rows(300, 32, 6, 0.3, seed=8)
    q = x[::50] + 0.03
    ij, _ = jm.matching_fractional_dis(15, x, q)
    it, _ = tm.matching_fractional_dis(15, x, q, device="cpu")
    sj, _ = jh.fractional_topk(jm.normalize_rows(jnp.asarray(x)),
                               jm.normalize_rows(jnp.asarray(q)), 15)
    assert_same_ranks(sj, ij, sj, it, tie=1e-5)


def _pq_net_inputs(seed=9):
    rng = np.random.default_rng(seed)
    M, Ks, ds = 4, 16, 8
    flat = rng.standard_normal((Ks, M * ds)).astype(np.float32)
    codes = rng.integers(0, Ks, (260, M)).astype(np.int32)
    codes[200:] = codes[:60]                        # repeated codes: exact ties
    gallery = clustered_rows(260, M * ds, 5, 0.3, seed=seed)
    q = gallery[::26] + 0.05
    return flat, codes, gallery, q, M


def test_matching_pq_net_matches_jax():
    flat, codes, _, q, M = _pq_net_inputs()
    ij, _ = jm.matching_PQ_Net(20, flat, q, M, codes)
    it, tpq = tm.matching_PQ_Net(20, flat, q, M, codes, device="cpu")
    assert it.dtype == np.int64 and tpq > 0
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("K", [10, 200])
def test_matching_pq_net_bucket_matches_jax(monkeypatch, K):
    """JAX's k-means init substituted at the port's ``_init_centers`` seam
    (the matcher's fit uses the default seed, JAX's default key); at K=200
    each query's bucket is shorter than K and the row pads with -1."""
    def jax_init(x, k, seed, init):
        c = jkm._init_centers(jnp.asarray(x.cpu().numpy()), k, jax.random.PRNGKey(seed), init)
        return torch.from_numpy(np.array(c))

    monkeypatch.setattr(tkm, "_init_centers", jax_init)
    flat, codes, gallery, q, M = _pq_net_inputs()
    ij, _ = jm.matching_PQ_Net_bucket(K, flat, q, M, codes, gallery, n_buckets=5)
    it, _ = tm.matching_PQ_Net_bucket(K, flat, q, M, codes, gallery, n_buckets=5,
                                      device="cpu")
    np.testing.assert_array_equal(it, ij)
    assert (K == 200) == bool((it == -1).any())


@pytest.mark.cuda
def test_cuda_hamming_matches_cpu():
    """On the card: packed codes and the Hamming scan's ids and scores equal
    the CPU's (integer arithmetic throughout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(10)
    bits = rng.random((3000, 512)) > 0.5
    q = bits[::300] ^ (rng.random((10, 512)) > 0.9)
    cpu = th.pack_bits(torch.from_numpy(bits)), th.pack_bits(torch.from_numpy(q))
    gpu = th.pack_bits(torch.from_numpy(bits).cuda()), th.pack_bits(torch.from_numpy(q).cuda())
    assert torch.equal(gpu[0].cpu().view(torch.int32), cpu[0].view(torch.int32))
    s_c, i_c = th.hamming_topk(*cpu, 50)
    s_g, i_g = th.hamming_topk(*gpu, 50)
    assert torch.equal(i_g.cpu(), i_c) and torch.equal(s_g.cpu(), s_c)
