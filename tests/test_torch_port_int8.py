"""The int8 scan (``ops.int8``) and ``Int8FlatIndex`` of the port against the
JAX package: codes and scales exactly, ``int8_topk`` in its one-shot,
N-chunked and query-blocked forms (patched budgets), ``int8_topk_rerank``,
artifacts both ways, and ``matching_L2_int8``; on the card, ids equal to the
CPU's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import flat as jflat
from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import matchers as jm
from image_search_engine_for_historical_research_tpu.index import save_index as j_save_index
from image_search_engine_for_historical_research_tpu.ops import int8 as ji8
from image_search_engine_for_historical_research_tpu_torch.index import flat as tflat
from image_search_engine_for_historical_research_tpu_torch.index import load_index, save_index
from image_search_engine_for_historical_research_tpu_torch.index import matchers as tm
from image_search_engine_for_historical_research_tpu_torch.ops import int8 as ti8
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_arrays,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _gallery(n, d, seed, dup=0):
    """Unit rows; the last ``dup`` repeat the first ones (exact score ties)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if dup:
        x[n - dup:] = x[:dup]
    q = (x[rng.choice(n, 9, replace=False)] + 0.1 * rng.standard_normal((9, d)))
    return x, q.astype(np.float32)


def _quantized(x):
    codes, scales = ji8.quantize_rows_int8(jnp.asarray(x))
    return np.array(codes), np.array(scales)


def test_quantize_matches_jax_exactly(monkeypatch):
    """Codes and scales bit for bit, through the block path (a patched
    chunk; host input uploaded block-wise) and with an all-zero row."""
    x, _ = _gallery(300, 40, 0)
    x[7] = 0.0
    x[9] *= 50.0
    cj, sj = ji8.quantize_rows_int8(x, chunk=64)
    ct, st = ti8.quantize_rows_int8(x, chunk=64, device="cpu")
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[7] == 0 and (ct[7] == 0).all()
    ct2, st2 = ti8.quantize_rows_int8(torch.from_numpy(x))          # one block, a tensor
    assert torch.equal(ct2, ct) and torch.equal(st2, st)


@pytest.mark.parametrize("form", ["oneshot", "chunked", "qblock"])
def test_int8_topk_matches_jax(monkeypatch, form):
    """Ids and scores equal JAX's with exact ties (duplicate rows). The
    chunked form shrinks the one-shot budget in both packages (a chunk of
    128 rows over 515); the query-blocked form shrinks ``QBLOCK`` to 4."""
    n = {"oneshot": 300, "chunked": 515, "qblock": 301}[form]   # distinct jit shapes
    x, q = _gallery(n, 32, 1, dup=40)
    codes, scales = _quantized(x)
    if form == "chunked":
        for mod in (ji8, ti8):
            monkeypatch.setattr(mod, "ONESHOT_SCORE_BYTES", 9 * 300 * ti8.SCORE_BYTES_PER_ELT)
    if form == "qblock":
        for mod in (ji8, ti8):
            monkeypatch.setattr(mod, "QBLOCK", 4)
    sj, ij = ji8.int8_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), 20)
    st, it = ti8.int8_topk(torch.from_numpy(q), torch.from_numpy(codes.copy()),
                           torch.from_numpy(scales.copy()), 20)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_int8_topk_rerank_matches_jax():
    x, q = _gallery(400, 32, 2, dup=30)
    codes, scales = _quantized(x)
    rr = jnp.asarray(x).astype(jnp.bfloat16)
    sj, ij = ji8.int8_topk_rerank(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), rr,
                                  10, shortlist=64)
    rr_t = torch.from_numpy(x).to(torch.bfloat16)
    st, it = ti8.int8_topk_rerank(torch.from_numpy(q), torch.from_numpy(codes),
                                  torch.from_numpy(scales), rr_t, 10, shortlist=64)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rerank", ["bfloat16", "none"])
def test_index_artifacts_both_ways(tmp_path, rerank):
    """``build_flat_i8`` equals JAX's array for array; each package loads the
    other's artifact (``rerank_bf16`` as uint16) and searches it alike."""
    x, q = _gallery(260, 48, 3)
    jix = jflat.build_flat_i8(x * 3.0, rerank=rerank, shortlist=32, chunk=100)
    tix = tflat.build_flat_i8(x * 3.0, rerank=rerank, shortlist=32, chunk=100, device="cpu")
    assert_same_arrays(jix.to_arrays()[1], tix.to_arrays()[1], atol=0)
    assert jix.to_arrays()[0] == tix.to_arrays()[0]
    j_save_index(jix, str(tmp_path / "jax"))
    save_index(tix, str(tmp_path / "torch"))
    from_jax = load_index(str(tmp_path / "jax"), device="cpu")
    from_port = j_load_index(str(tmp_path / "torch"))
    assert isinstance(from_jax, tflat.Int8FlatIndex)
    assert_same_arrays(jix.to_arrays()[1], from_port.to_arrays()[1], atol=0)
    _, ij = from_port.search(jnp.asarray(q), 7)
    _, it = from_jax.search(q, 7)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_matching_l2_int8_matches_jax():
    """600 rows, above the default shortlist of 512: at a shortlist of all N
    rows JAX's ``approx_max_k`` (the re-rank route's default) returns the
    tied rows of duplicates in no fixed order, while the port's order is
    ``lax.top_k``'s."""
    x, q = _gallery(600, 32, 5, dup=20)
    for kw in ({}, {"rerank": "none"}):
        ij, _ = jm.matching_L2_int8(15, x, q, **kw)
        it, tpq = tm.matching_L2_int8(15, x, q, device="cpu", **kw)
        assert it.dtype == np.int64 and tpq > 0
        np.testing.assert_array_equal(it, ij)


@pytest.mark.cuda
def test_cuda_int8_ids_match_cpu():
    """On the card: the padded ``torch._int_mm`` (one query, a gallery that
    is not a multiple of 8, D not a multiple of 8) gives the CPU's int32
    products exactly, and the scan the CPU's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, q = _gallery(1003, 44, 6, dup=50)
    ix = tflat.build_flat_i8(x, rerank="none", device="cpu")
    gx = tflat.Int8FlatIndex(ix.codes.cuda(), ix.scales.cuda())
    qc, _ = ti8._quantize_block(torch.from_numpy(q))
    for rows in (1, 9):
        want = ti8._int_dot(qc[:rows], ix.codes)
        got = ti8._int_dot(qc[:rows].cuda(), gx.codes)
        assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(gx.search(q, 20)[1].cpu().numpy(), ix.search(q, 20)[1].numpy())
    rr = tflat.build_flat_i8(x, device="cpu")
    grr = tflat.Int8FlatIndex(rr.codes.cuda(), rr.scales.cuda(), rr.rerank_vectors.cuda())
    np.testing.assert_array_equal(grr.search(q, 20)[1].cpu().numpy(),
                                  rr.search(q, 20)[1].numpy())
