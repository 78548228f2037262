"""``IVFPQIndex`` / ``build_ivfpq`` of the port against the JAX package:
builds with JAX's fits substituted (OPQ, refine codes, virtual-list split,
an explicit ``seg``), the probe (one lax-ordered top-k over all probed
candidates, in query blocks) against JAX's probe scan, artifacts both ways,
streaming builds and the refused requests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_ivfpq as j_build
from image_search_engine_for_historical_research_tpu.index import ivfpq as jivf
from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import save_index as j_save_index
from image_search_engine_for_historical_research_tpu_torch.index import (
    IVFPQIndex,
    build_ivfpq,
    load_index,
    save_index,
)
from image_search_engine_for_historical_research_tpu_torch.index import ivfpq as tivf
from image_search_engine_for_historical_research_tpu_torch.index import streaming
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
    # uneven clusters, so some lists outgrow the scan window
    rng = np.random.default_rng(6)
    x = np.concatenate([clustered_rows(n=1200, n_centers=30, seed=6),
                        clustered_rows(n=400, n_centers=2, spread=0.05, seed=7)])
    q = x[rng.integers(0, len(x), 9)] + 0.05 * rng.standard_normal((9, x.shape[1]))
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {"nlist": 16, "M": 8, "Ks": 32, "nprobe": 4},
    {"nlist": 16, "M": 8, "Ks": 32, "nprobe": 6, "refine_M": 8, "opq": True, "opq_iters": 2},
    {"nlist": 16, "M": 8, "Ks": 32, "nprobe": 4, "split_long": False, "refine_M": 8},
    {"nlist": 12, "M": 8, "Ks": 16, "nprobe": 5, "seg": 128, "refine_M": 8},
])
def test_build_equals_jax_with_its_fits(data, monkeypatch, kw):
    x, q = data
    substitute_jax_fits(monkeypatch)
    jix = j_build(x, normalize=False, iters=6, **kw)
    tix = build_ivfpq(x, normalize=False, iters=6, device="cpu", **kw)
    jm, jarr = jix.to_arrays()
    tm, tarr = tix.to_arrays()
    assert tm == jm
    assert_same_arrays(jarr, tarr)
    for method in ("adc", "adc+refine") if "refine_M" in kw else ("adc",):
        sj, ij = jix.search(q, 10, method=method)
        st, it = tix.search(q, 10, method=method)
        assert_same_ranks(sj, ij, st, it)


@pytest.fixture(scope="module")
def jax_index(data):
    x, _ = data
    return j_build(x, nlist=16, M=8, Ks=32, nprobe=6, iters=5, refine_M=8, seg=128)


@pytest.mark.parametrize("budget", [tivf.PROBE_BUDGET, 1])
def test_probe_equals_jax_scan(data, jax_index, monkeypatch, budget):
    """One top-k over the probe-ordered candidates behind k empty slots is
    JAX's per-probe scan: scores, ids and flat positions, empty slots
    included (k above the probed candidates), in one block or one query a
    block."""
    monkeypatch.setattr(tivf, "PROBE_BUDGET", budget)
    x, q = data
    meta, arrays = jax_index.to_arrays()
    tix = IVFPQIndex.from_arrays(meta, arrays, device="cpu")
    for k, nprobe in ((10, 6), (700, 3)):
        ref = jivf._ivfpq_search(
            jax_index.coarse_centers, jax_index.codewords, jax_index.flat_codes,
            jax_index.flat_ids, jax_index.offsets, jax_index.lens, jnp.asarray(q), None, k,
            nprobe, jax_index.seg)
        got = tivf._ivfpq_search(tix.coarse_centers, tix.codewords, tix.flat_codes, tix.flat_ids,
                                 tix.offsets, tix.lens, torch.from_numpy(q), None, k, nprobe,
                                 tix.seg)
        assert_same_ranks(ref[0], ref[1], got[0], got[1])
        same = np.asarray(ref[1]) == got[1].numpy()
        np.testing.assert_array_equal(got[2].numpy()[same], np.asarray(ref[2])[same])
        assert (got[1].numpy() == -1).sum() == (np.asarray(ref[1]) == -1).sum()


@pytest.mark.parametrize("method", ["adc", "adc+refine"])
def test_artifacts_load_both_ways(data, jax_index, tmp_path, method):
    x, q = data
    j_save_index(jax_index, str(tmp_path / "j"))
    tix = load_index(str(tmp_path / "j"), device="cpu")
    sj, ij = jax_index.search(q, 10, method=method, nprobe=4)
    st, it = tix.search(q, 10, method=method, nprobe=4)
    assert_same_ranks(sj, ij, st, it)
    save_index(tix, str(tmp_path / "t"))
    back = j_load_index(str(tmp_path / "t"))
    assert_same_arrays(jax_index.to_arrays()[1], back.to_arrays()[1], atol=0)
    assert tix.n == len(x)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_streaming_build_equals_in_memory(data, monkeypatch, as_tensor):
    """Normalized rows on a 256-row build grid, 500-row chunks that straddle
    its pieces: the streamed build is the in-memory one, array for array."""
    x, _ = data
    monkeypatch.setattr(streaming, "GRID_ROWS", 256)
    kw = dict(nlist=12, M=8, Ks=16, nprobe=4, iters=4, refine_M=8, device="cpu")
    mem = build_ivfpq(x, **kw)

    def chunks():
        for s in range(0, len(x), 500):
            yield torch.from_numpy(x[s:s + 500].copy()) if as_tensor else x[s:s + 500]

    st = build_ivfpq(chunks, n=len(x), **kw)
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)


def test_builds_from_one_seed_are_identical_with_threads(data):
    """Centroid sums keep their row order with several CPU threads (the
    CPU's accumulating ``index_put_`` would not), so two builds from one
    seed give identical arrays."""
    x, _ = data
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        kw = dict(nlist=16, M=8, Ks=32, nprobe=4, iters=4, refine_M=8, device="cpu")
        assert_same_arrays(build_ivfpq(x, **kw).to_arrays()[1],
                           build_ivfpq(x, **kw).to_arrays()[1], atol=0)
    finally:
        torch.set_num_threads(n)


def test_refused_requests_raise_as_in_jax(data):
    x, q = data
    jix = j_build(x, nlist=8, M=4, Ks=16, nprobe=4, iters=2)
    tix = build_ivfpq(x, nlist=8, M=4, Ks=16, nprobe=4, iters=2, device="cpu")
    cases = [
        (lambda: jix.search(q, 5, method="adc+refine"), lambda: tix.search(q, 5, method="adc+refine")),
        (lambda: jix.search(q, 5, method="exact"), lambda: tix.search(q, 5, method="exact")),
        (lambda: j_build(lambda: iter([x]), nlist=8, M=4, Ks=16),
         lambda: build_ivfpq(lambda: iter([x]), nlist=8, M=4, Ks=16, device="cpu")),
    ]
    for jcall, tcall in cases:
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(te.value) == str(je.value)


@pytest.mark.cuda
def test_probe_on_the_card_matches_the_cpu(data, jax_index):
    """The IVF probe and the refine re-rank on the card against the CPU, on
    one artifact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, q = data
    meta, arrays = jax_index.to_arrays()
    cpu, gpu = IVFPQIndex.from_arrays(meta, arrays, "cpu"), IVFPQIndex.from_arrays(meta, arrays,
                                                                                    "cuda")
    for method in ("adc", "adc+refine"):
        sc, ic = cpu.search(q, 20, method=method)
        sg, ig = gpu.search(q, 20, method=method)
        assert_same_ranks(sc, ic, sg.cpu(), ig.cpu())


@pytest.mark.cuda
def test_two_card_builds_from_one_seed_are_identical(data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, _ = data
    kw = dict(nlist=16, M=8, Ks=32, nprobe=4, refine_M=8, opq=True, opq_iters=2, device="cuda")
    assert_same_arrays(build_ivfpq(x, **kw).to_arrays()[1], build_ivfpq(x, **kw).to_arrays()[1],
                       atol=0)
