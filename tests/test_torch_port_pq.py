"""k-means, ``ops.pq``, ``index.pq`` and the streaming helpers of the port
against the JAX package: Lloyd from JAX's own initial centres, codebooks
carried in from JAX (encode, decode, LUTs, every ADC scan, the refine
re-rank), the port's own fits by quality, whole builds with JAX's fits
substituted at the port's seams, streaming builds, artifacts both ways and
the refused requests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_pq as j_build_pq
from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import save_index as j_save_index
from image_search_engine_for_historical_research_tpu.index import streaming as j_streaming
from image_search_engine_for_historical_research_tpu.ops import kmeans as jkm
from image_search_engine_for_historical_research_tpu.ops import pq as jpq
from image_search_engine_for_historical_research_tpu_torch.index import PQIndex, build_pq
from image_search_engine_for_historical_research_tpu_torch.index import load_index, save_index
from image_search_engine_for_historical_research_tpu_torch.index import streaming
from image_search_engine_for_historical_research_tpu_torch.ops import kmeans as tkm
from image_search_engine_for_historical_research_tpu_torch.ops import pq as tpq
from image_search_engine_for_historical_research_tpu_torch.ops.topk import _top_exact
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_arrays,
    assert_same_ranks,
    clustered_rows,
    one_torch_thread,
    substitute_jax_fits,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data():
    x = clustered_rows()
    rng = np.random.default_rng(1)
    q = x[rng.integers(0, len(x), 9)] + 0.05 * rng.standard_normal((9, x.shape[1]))
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_codebooks(data):
    """JAX fits carried into the port: plain (Ks=64), OPQ (Ks=32), 4-bit
    (Ks=16) and a uint16-code codebook (Ks=512, on 2,000 rows)."""
    x, _ = data
    xj = jnp.asarray(x)
    big = clustered_rows(n=2000, seed=5)
    return {
        "plain": (jpq.pq_train(xj, M=8, Ks=64, iters=8), x),
        "opq": (jpq.opq_train(xj, M=8, Ks=32, iters=6, opq_iters=2), x),
        "4bit": (jpq.pq_train(xj, M=8, Ks=16, iters=8), x),
        "uint16": (jpq.pq_train(jnp.asarray(big), M=8, Ks=512, iters=3), big),
    }


def _carry(cb):
    return tpq.PQCodebook.from_numpy(np.asarray(cb.codewords),
                                     None if cb.rotation is None else np.asarray(cb.rotation))


@pytest.mark.parametrize("init, matmul_dtype", [("kmeans++", None), ("points", None),
                                                ("kmeans++", "bf16")])
def test_lloyd_from_jax_init_reaches_jax_centres(data, monkeypatch, init, matmul_dtype):
    x, _ = data
    key = jax.random.PRNGKey(3)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if matmul_dtype else (None, None)
    init_c = np.asarray(jkm._init_centers(jnp.asarray(x), 40, key, init))
    monkeypatch.setattr(tkm, "_init_centers", lambda *a: torch.tensor(init_c))
    cj, aj = jkm.kmeans_fit(jnp.asarray(x), 40, 12, key, chunk=1024, matmul_dtype=jdt,
                            init=init)
    ct, at = tkm.kmeans_fit(torch.from_numpy(x), 40, 12, chunk=1024, matmul_dtype=tdt,
                            init=init)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(tkm._assign(torch.from_numpy(x), ct).numpy(),
                                  np.asarray(jkm._assign(jnp.asarray(x), cj)))


def test_init_draws_come_from_a_host_generator(data):
    """The same seed gives the same centres; k-means++ and points pick data
    rows, distinct ones; an empty cluster keeps its centre."""
    x = torch.from_numpy(data[0])
    for init in ("kmeans++", "points"):
        a = tkm._init_centers(x, 32, 5, init)
        assert torch.equal(a, tkm._init_centers(x, 32, 5, init))
        assert not torch.equal(a, tkm._init_centers(x, 32, 6, init))
        hit = (a[:, None, :] == x[None]).all(-1).any(1)
        assert bool(hit.all()) and len(torch.unique(a, dim=0)) == 32
    far = torch.full((1, x.shape[1]), 100.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tkm, "_init_centers", lambda *a: torch.cat([x[:1], far]))
        centers, assign = tkm.kmeans_fit(x, 2, 3)
    assert torch.equal(centers[1], far[0]) and bool((assign == 0).all())
    cb, ab = tkm.kmeans_fit_batched(torch.stack([x[:200], x[200:400]]), 8, 4, seed=7)
    c1, a1 = tkm.kmeans_fit(x[200:400], 8, 4, seed=tkm.subspace_seed(7, 1))
    assert torch.equal(cb[1], c1) and torch.equal(ab[1], a1)


def _sequential_kmeanspp(x, k, seed):
    """The k-means++ init as a plain loop, one fit and one step at a time
    (the form the port had before its fits were batched): the rows a
    batched fit must pick."""
    gen = tkm._host_generator(seed)
    N = x.shape[0]
    if N > tkm.INIT_SAMPLE:
        x = x[torch.randperm(N, generator=gen)[:tkm.INIT_SAMPLE]]
        N = tkm.INIT_SAMPLE
    first = int(torch.randint(0, N, (), generator=gen))
    gumbel = torch.empty((k - 1, N)).exponential_(generator=gen).log_().neg_()
    rows = [first]
    min_d2 = ((x - x[first][None, :]) ** 2).sum(1)
    for j in range(1, k):
        rows.append(int(torch.argmax(torch.log(torch.clamp(min_d2, min=1e-30)) + gumbel[j - 1])))
        min_d2 = torch.minimum(min_d2, ((x - x[rows[-1]][None, :]) ** 2).sum(1))
    return x[rows]


@pytest.mark.parametrize("init, sample, k", [("kmeans++", None, 24), ("kmeans++", 256, 24),
                                             ("points", None, 24), ("kmeans++", None, 70)])
def test_batched_fits_start_from_the_rows_of_single_fits(data, monkeypatch, init, sample, k):
    """Each fit of a batch draws from its own seed's host generator in a
    single fit's order (subsample above ``INIT_SAMPLE``, first row, Gumbel
    noise, drawn ``GUMBEL_STEPS`` steps at a time: ``k=70`` takes three
    blocks), so it picks the rows of a one-at-a-time k-means++ loop that
    draws all its noise at once; the batched Lloyd then reaches the single
    fits' centres."""
    if sample is not None:
        monkeypatch.setattr(tkm, "INIT_SAMPLE", sample)
    x = torch.from_numpy(data[0])
    M = 4
    sub = x.reshape(x.shape[0], M, -1).transpose(0, 1)        # (M, N, 16), strided
    seeds = [tkm.subspace_seed(9, m) for m in range(M)]
    init_b = tkm._init_centers_batched(sub, k, seeds, init)
    for m in range(M):
        single = tkm._init_centers(sub[m].contiguous(), k, seeds[m], init)
        assert torch.equal(init_b[m], single)
        if init == "kmeans++":
            assert torch.equal(single, _sequential_kmeanspp(sub[m].contiguous(), k, seeds[m]))
    cb, ab = tkm.kmeans_fit_batched(sub, k, 6, seed=9, init=init)
    for m in range(M):
        c1, a1 = tkm.kmeans_fit(sub[m].contiguous(), k, 6, seed=seeds[m], init=init)
        np.testing.assert_allclose(cb[m].numpy(), c1.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(ab[m], a1)


@pytest.mark.parametrize("kw", [{"M": 8, "Ks": 32}, {"M": 16, "Ks": 16, "train_sample": 900},
                                {"M": 4, "Ks": 2100, "iters": 2}])
def test_pq_train_equals_a_loop_of_subspace_fits(data, kw):
    """``pq_train``'s batched subspaces equal one ``kmeans_fit`` a subspace
    from ``subspace_seed(seed, m)`` on the same rows (1e-6), k-means++ and
    (above ``LARGE_KS``) the points init with bf16 assignments."""
    x = torch.from_numpy(data[0])
    if kw["Ks"] > tpq.LARGE_KS:
        x = torch.from_numpy(clustered_rows(n=2400, seed=3))
    cb = tpq.pq_train(x, seed=5, **kw)
    N, M, Ks = x.shape[0], kw["M"], kw["Ks"]
    ts = kw.get("train_sample")
    big = Ks > tpq.LARGE_KS
    if big and ts is None:
        ts = max(65536, 32 * Ks)
    rows = x[torch.as_tensor(tpq.train_indices(N, ts, 5))] if ts is not None and ts < N else x
    ds = x.shape[1] // M
    for m in range(M):
        c, _ = tkm.kmeans_fit(rows[:, m * ds:(m + 1) * ds].contiguous(), Ks, kw.get("iters", 20),
                              seed=tkm.subspace_seed(5, m),
                              matmul_dtype=torch.bfloat16 if big else None,
                              init="points" if big else "kmeans++")
        np.testing.assert_allclose(cb.codewords[m].numpy(), c.numpy(), rtol=0, atol=1e-6)


def test_two_opq_fits_from_one_seed_are_identical(data):
    x = torch.from_numpy(data[0])
    a = tpq.opq_train(x, M=8, Ks=32, iters=6, opq_iters=3, seed=4)
    b = tpq.opq_train(x, M=8, Ks=32, iters=6, opq_iters=3, seed=4)
    assert torch.equal(a.codewords, b.codewords) and torch.equal(a.rotation, b.rotation)
    c = tpq.opq_train(x, M=8, Ks=32, iters=6, opq_iters=3, seed=5)
    assert not torch.equal(a.codewords, c.codewords)


@pytest.mark.parametrize("Ks", [32, 40])
def test_opq_rounds_share_their_draws(data, monkeypatch, Ks):
    """OPQ's rounds draw once and share the numbers (``shared_draws``, the
    noise blocks kept once drawn; ``Ks=40`` takes two): the codebook and
    rotation equal a fit whose every round draws anew, and the draws are
    made once a fit shape."""
    import contextlib

    x = torch.from_numpy(data[0])
    calls = []
    draw = tkm._init_draws
    monkeypatch.setattr(tkm, "_init_draws", lambda *a: calls.append(a[1:]) or draw(*a))
    shared = tpq.opq_train(x, M=8, Ks=Ks, iters=6, opq_iters=3, seed=4)
    assert len(calls) == 1
    monkeypatch.setattr(tpq, "shared_draws", contextlib.nullcontext)
    fresh = tpq.opq_train(x, M=8, Ks=Ks, iters=6, opq_iters=3, seed=4)
    assert len(calls) == 1 + 4
    assert torch.equal(shared.codewords, fresh.codewords)
    assert torch.equal(shared.rotation, fresh.rotation)
    assert tkm._SHARED.draws is None


def test_train_indices_and_top_lax_are_jax_s():
    """``train_indices`` and ``ops.topk._top_exact`` (``lax.top_k``'s
    choice among equal scores) are the JAX package's."""
    np.testing.assert_array_equal(tpq.train_indices(1000, 300, 9), jpq.train_indices(1000, 300, 9))
    rng = np.random.default_rng(0)
    s = rng.integers(0, 5, (6, 300)).astype(np.float32)      # many equal scores
    s[0, :] = 1.0
    s[1, 7:] = -np.inf
    for k in (1, 5, 40, 300):
        vj, ij = jax.lax.top_k(jnp.asarray(s), k)
        vt, it = _top_exact(torch.from_numpy(s), k)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("name", ["plain", "opq", "uint16"])
def test_carried_codebook_encode_decode_and_tables(jax_codebooks, data, name):
    cb, x = jax_codebooks[name]
    tcb = _carry(cb)
    cj = np.asarray(jpq.pq_encode(cb, jnp.asarray(x)))
    ct = tpq.pq_encode(tcb, torch.from_numpy(x), chunk=512)
    assert tpq.codes_to_numpy(ct).dtype == cj.dtype == (np.uint16 if name == "uint16" else np.uint8)
    np.testing.assert_array_equal(tpq.codes_to_numpy(ct), cj)
    np.testing.assert_allclose(tpq.pq_decode(tcb, ct).numpy(),
                               np.asarray(jpq.pq_decode(cb, jnp.asarray(cj))), rtol=0, atol=1e-5)
    q = data[1]
    for jf, tf in ((jpq.pq_dist_table, tpq.pq_dist_table), (jpq.pq_ip_table, tpq.pq_ip_table)):
        np.testing.assert_allclose(tf(tcb, torch.from_numpy(q)).numpy(),
                                   np.asarray(jf(cb, jnp.asarray(q))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name, method, packed4", [
    ("plain", "onehot", False), ("plain", "gather", False), ("opq", "auto", False),
    ("uint16", "gather", False), ("4bit", "onehot", True), ("4bit", "gather", True),
])
def test_carried_codebook_pq_search(jax_codebooks, data, name, method, packed4):
    cb, x = jax_codebooks[name]
    q = data[1]
    codes = np.asarray(jpq.pq_encode(cb, jnp.asarray(x)))
    if packed4:
        codes = np.asarray(jpq.pq_pack4(jnp.asarray(codes)))
        np.testing.assert_array_equal(
            tpq.pq_pack4(torch.from_numpy(np.asarray(jpq.pq_unpack4(jnp.asarray(codes))))).numpy(),
            codes)
    jmethod = "onehot" if method == "auto" else method
    sj, ij = jpq.pq_search(cb, jnp.asarray(codes), jnp.asarray(q), 30, chunk=256, method=jmethod,
                           packed4=packed4)
    st, it = tpq.pq_search(_carry(cb), tpq.codes_from_numpy(codes, "cpu"), torch.from_numpy(q),
                           30, chunk=256, method=method, packed4=packed4)
    assert_same_ranks(sj, ij, st, it)


def test_carried_codebook_refine_rerank(jax_codebooks, data):
    """``pq_refine_rerank`` over candidate rows with invalid slots and
    repeated coarse rows."""
    (cb, x), (rcb, _) = jax_codebooks["plain"], jax_codebooks["opq"]
    q = data[1]
    codes = np.asarray(jpq.pq_encode(cb, jnp.asarray(x)))
    rcodes = np.asarray(jpq.pq_encode(rcb, jnp.asarray(x)))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, len(x), (9, 40)).astype(np.int32)
    rows = np.where(rng.random((9, 40)) < 0.3, ids[:, :1], ids)
    valid = rng.random((9, 40)) > 0.1
    args = (rows, ids, valid)
    sj, ij = jpq.pq_refine_rerank(cb, jnp.asarray(codes), rcb, jnp.asarray(rcodes),
                                  jnp.asarray(q), *map(jnp.asarray, args), 12)
    st, it = tpq.pq_refine_rerank(_carry(cb), torch.from_numpy(codes), _carry(rcb),
                                  torch.from_numpy(rcodes), torch.from_numpy(q),
                                  *map(torch.from_numpy, args), 12)
    assert_same_ranks(sj, ij, st, it)


def _qerr_jax(x, cb):
    xhat = jpq.pq_decode(cb, jpq.pq_encode(cb, jnp.asarray(x)))
    return float(np.mean(np.sum((x - np.asarray(xhat)) ** 2, axis=1)))


def _qerr_port(x, cb):
    xhat = tpq.pq_decode(cb, tpq.pq_encode(cb, torch.from_numpy(x)))
    return float(np.mean(np.sum((x - xhat.numpy()) ** 2, axis=1)))


def test_own_fits_match_jax_quality(data):
    """The port's own PQ and OPQ fits (its own random draws) come within 2%
    of the JAX package's quantization error; the rotation is orthogonal."""
    x, _ = data
    for jtrain, ttrain, kw in ((jpq.pq_train, tpq.pq_train, {}),
                               (jpq.opq_train, tpq.opq_train, {"opq_iters": 3})):
        jcb = jtrain(jnp.asarray(x), M=8, Ks=32, iters=10, **kw)
        tcb = ttrain(torch.from_numpy(x), M=8, Ks=32, iters=10, **kw)
        ej, et = _qerr_jax(x, jcb), _qerr_port(x, tcb)
        assert et <= 1.02 * ej, (jtrain.__name__, et, ej)
        if tcb.rotation is not None:
            r = tcb.rotation.double()
            err = (r @ r.T - torch.eye(r.shape[0], dtype=torch.float64)).abs().max()
            assert float(err) <= 1e-5


@pytest.mark.parametrize("kw", [
    {"M": 8, "Ks": 32},
    {"M": 8, "Ks": 32, "refine_M": 12},                  # clamps to 8
    {"M": 8, "Ks": 32, "opq": True, "opq_iters": 2, "refine_M": 8},
    {"M": 8, "Ks": 16, "pack4": True},
    {"M": 8, "Ks": 512, "train_sample": 700},             # uint16 codes, subsampled fit
])
def test_build_pq_equals_jax_with_its_fits(data, monkeypatch, kw):
    x, q = data
    substitute_jax_fits(monkeypatch)
    jix = j_build_pq(x, normalize=False, iters=6, **kw)
    tix = build_pq(x, normalize=False, iters=6, device="cpu", **kw)
    assert_same_arrays(jix.to_arrays()[1], tix.to_arrays()[1])
    assert tix.to_arrays()[0] == jix.to_arrays()[0]
    sj, ij = jix.search(q, 10)
    st, it = tix.search(q, 10)
    assert_same_ranks(sj, ij, st, it)


def _chunks(x, sizes, as_tensor):
    def gen():
        s = 0
        for c in sizes:
            part = x[s:s + c]
            yield torch.from_numpy(part.copy()) if as_tensor else part
            s += c
    return gen


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("kw", [{"M": 8, "Ks": 32, "train_sample": 600},
                                {"M": 8, "Ks": 32, "train_sample": 600, "opq": True,
                                 "opq_iters": 2, "refine_M": 8}])
def test_streaming_build_equals_in_memory(data, as_tensor, kw):
    x, _ = data
    mem = build_pq(x, iters=5, device="cpu", **kw)
    st = build_pq(_chunks(x, [700, 500, 300], as_tensor), n=len(x), iters=5, device="cpu", **kw)
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_streaming_build_on_a_small_grid_equals_in_memory(data, monkeypatch, as_tensor):
    """With a 256-row build grid, normalized rows and chunks that straddle
    grid pieces, the streamed build is the in-memory build, array for array."""
    x, _ = data
    monkeypatch.setattr(streaming, "GRID_ROWS", 256)
    kw = {"M": 8, "Ks": 32, "train_sample": 600, "opq": True, "opq_iters": 2, "refine_M": 8,
          "iters": 4}
    mem = build_pq(x, device="cpu", **kw)
    st = build_pq(_chunks(x, [700, 500, 300], as_tensor), n=len(x), device="cpu", **kw)
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)
    pieces = list(streaming.grid_pieces(_chunks(x, [700, 800], as_tensor), len(x),
                                        normalize=True))
    assert [s for s, _ in pieces] == list(range(0, len(x), 256))
    np.testing.assert_array_equal(torch.cat([p for _, p in pieces]).numpy(),
                                  streaming.f32_rows(torch.from_numpy(x), True).numpy())


@pytest.mark.parametrize("as_tensor", [False, True])
def test_stream_gather_rows_in_caller_order(data, as_tensor):
    x, _ = data
    idx = [np.array([1400, 3, 77, 700, 5]), np.array([9, 1499, 0])]
    got = streaming.stream_gather_rows(_chunks(x, [700, 800], as_tensor), len(x), idx,
                                       normalize=True)
    ref = j_streaming.stream_gather_rows(_chunks(x, [700, 800], False), len(x), idx,
                                         normalize=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    pieces = list(streaming.stream_encode_pieces(_chunks(x, [700, 800], as_tensor), len(x), 300))
    # cut at multiples of 300 across the source's chunk boundary
    assert [s for s, _ in pieces] == [0, 300, 600, 900, 1200]
    np.testing.assert_array_equal(torch.cat([p for _, p in pieces]).numpy(), x)


@pytest.mark.parametrize("kw", [{"M": 8, "Ks": 32, "refine_M": 8, "opq": True, "opq_iters": 2},
                                {"M": 8, "Ks": 512, "train_sample": 700},
                                {"M": 8, "Ks": 16, "pack4": True}])
def test_artifacts_load_both_ways(data, tmp_path, kw):
    x, q = data
    jix = j_build_pq(x, iters=4, **kw)
    j_save_index(jix, str(tmp_path / "j"))
    tix = load_index(str(tmp_path / "j"), device="cpu")
    assert isinstance(tix, PQIndex)
    methods = ["adc"] + (["adc+refine"] if "refine_M" in kw else [])
    for method in methods:
        sj, ij = jix.search(q, 10, method=method)
        st, it = tix.search(q, 10, method=method)
        assert_same_ranks(sj, ij, st, it)
    save_index(tix, str(tmp_path / "t"))
    back = j_load_index(str(tmp_path / "t"))
    assert_same_arrays(jix.to_arrays()[1], back.to_arrays()[1], atol=0)
    sj2, ij2 = back.search(q, 10)
    np.testing.assert_array_equal(np.asarray(ij2), np.asarray(jix.search(q, 10)[1]))


def test_refused_requests_raise_as_in_jax(data):
    x, q = data
    plain_t = build_pq(x, M=8, Ks=16, iters=2, device="cpu")
    plain_j = j_build_pq(x, M=8, Ks=16, iters=2)
    cases = [
        (lambda: plain_j.search(q, 5, method="adc+refine"),
         lambda: plain_t.search(q, 5, method="adc+refine")),
        (lambda: j_build_pq(x, M=8, Ks=16, pack4=True, refine_M=8),
         lambda: build_pq(x, M=8, Ks=16, pack4=True, refine_M=8, device="cpu")),
        (lambda: j_build_pq(x, M=8, Ks=32, iters=1, pack4=True),
         lambda: build_pq(x, M=8, Ks=32, iters=1, pack4=True, device="cpu")),
        (lambda: j_build_pq(lambda: iter([x]), M=8, Ks=16),
         lambda: build_pq(lambda: iter([x]), M=8, Ks=16, device="cpu")),
    ]
    for jcall, tcall in cases:
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(te.value) == str(je.value)


@pytest.mark.cuda
def test_pq_search_on_the_card_matches_the_cpu(data):
    """One artifact searched on the card and on the CPU (ADC scan with
    uint16 codes and the refine re-rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, q = data
    ix = build_pq(clustered_rows(n=3000, seed=2), M=8, Ks=512, refine_M=8, iters=4, device="cpu")
    meta, arrays = ix.to_arrays()
    cpu, gpu = PQIndex.from_arrays(meta, arrays, "cpu"), PQIndex.from_arrays(meta, arrays, "cuda")
    for method in ("adc", "adc+refine"):
        sc, ic = cpu.search(q, 20, method=method)
        sg, ig = gpu.search(q, 20, method=method)
        assert_same_ranks(sc, ic, sg.cpu(), ig.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("as_tensor", [False, True])
def test_host_chunks_stream_into_a_card_build(data, monkeypatch, as_tensor):
    """Host chunks (numpy arrays or CPU tensors) streamed into a card build
    give the card's in-memory build bit for bit: normalized rows, OPQ,
    refine codes, and chunks that straddle the pieces of a 256-row grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, _ = data
    monkeypatch.setattr(streaming, "GRID_ROWS", 256)
    kw = {"M": 8, "Ks": 32, "train_sample": 600, "refine_M": 8, "iters": 5, "opq": True,
          "opq_iters": 2}
    mem = build_pq(x, device="cuda", **kw)
    st = build_pq(_chunks(x, [700, 500, 300], as_tensor), n=len(x), device="cuda", **kw)
    assert st.codes.device.type == "cuda"
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)


@pytest.mark.cuda
def test_two_card_builds_from_one_seed_are_identical(data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, _ = data
    for kw in ({"M": 8, "Ks": 32, "refine_M": 8}, {"M": 8, "Ks": 512, "train_sample": 1000}):
        a = build_pq(x, device="cuda", **kw).to_arrays()[1]
        b = build_pq(x, device="cuda", **kw).to_arrays()[1]
        assert_same_arrays(a, b, atol=0)
