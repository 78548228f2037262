"""The ``scan_topk`` kernel (``csrc/scan_topk.cu``) against its plain
version on the card. Every test here needs an NVIDIA GPU (the kernel has no
CPU mode): ``python -m pytest tests/test_torch_port_scan_topk.py -m cuda``.
The CPU side (the plain version and ``ops.topk``'s routing) is held in
``test_torch_port_topk.py``."""

import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu_torch.index import build_flat
from image_search_engine_for_historical_research_tpu_torch.ops import scan_topk as sk
from image_search_engine_for_historical_research_tpu_torch.ops.topk import exact_topk
from image_search_engine_for_historical_research_tpu_torch.rerank.qe import qge1

R1M, D = 1_007_323, 2048
TOL = 1e-5  # f32 sums over D = 2048 in another order than cuBLAS's


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def gallery():
    """1,007,323 unit rows at D = 2048 on the card (8.25 GB) and 128 unit
    queries; smaller galleries are its leading rows, fewer queries its
    leading queries."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(R1M, D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    q = torch.randn(128, D, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    yield q, x
    del x
    torch.cuda.empty_cache()


def assert_topk_close(s_ref, i_ref, s, i, tol=TOL):
    """Scores within ``tol``; ids equal wherever the reference's score lies
    more than ``tol`` from its neighbours in the row."""
    s_ref, i_ref, s, i = (a.cpu().numpy() for a in (s_ref, i_ref, s, i))
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=tol)
    gap = np.abs(np.diff(s_ref, axis=1)) > tol
    untied = np.ones_like(s_ref, bool)
    untied[:, 1:] &= gap
    untied[:, :-1] &= gap
    np.testing.assert_array_equal(i[untied], i_ref[untied])


@pytest.mark.cuda
@pytest.mark.parametrize("n", ["k", 1037, R1M])
@pytest.mark.parametrize("k", [1, 10, 100, sk.MAX_K])
@pytest.mark.parametrize("Q", [1, 16, 70, sk.MAX_Q])
def test_kernel_matches_plain(gallery, Q, k, n):
    q, x = gallery
    n = k if n == "k" else n
    qq, xx = q[:Q], x[:n]
    before = sk.launches
    s, i = sk.scan_topk(qq, xx, k)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert s.dtype == torch.float32 and i.dtype == torch.int64 and s.shape == (Q, k)
    s_ref, i_ref = sk.scan_topk_reference(qq, xx, k)
    assert_topk_close(s_ref, i_ref, s, i)
    # descending, and each row's ids distinct and in range
    assert bool((s[:, 1:] <= s[:, :-1]).all())
    ids = i.cpu().numpy()
    assert ids.min() >= 0 and ids.max() < n
    assert all(len(set(r)) == k for r in ids.tolist())


@pytest.mark.cuda
def test_the_library_was_built_with_the_routes_limits(gallery):
    """``MAX_Q`` and ``MAX_K``, which the route reads without building the
    library, are the limits the library was compiled with."""
    q, x = gallery
    sk.scan_topk(q[:1], x[:1000], 1)
    assert (sk._sizes["max_q"], sk._sizes["max_k"]) == (sk.MAX_Q, sk.MAX_K) == (72, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [sk.MAX_Q + 1, 128])
def test_above_the_largest_tile_exact_topk_keeps_cublas(gallery, Q):
    """Above 72 queries cuBLAS's query tiles are full and the route keeps
    it and ``torch.topk``: no launch, the same top-k."""
    q, x = gallery
    before = sk.launches
    s, i = exact_topk(q[:Q], x, 100)
    torch.cuda.synchronize()
    assert sk.launches == before
    assert_topk_close(*sk.scan_topk_reference(q[:Q], x, 100), s, i)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,k", [(1, 10), (70, 100), (5, 128)])
def test_duplicate_rows_select_the_lowest_ids_first(Q, k):
    """32 distinct unit rows, each stored 1,000 times (row u + 32 c), so the
    copies lie in many tiles and blocks: each query's list is the copies of
    its best rows, lowest ids first, and at the k-th score the lowest ids."""
    _card()
    rng = np.random.default_rng(7)
    base = rng.standard_normal((32, 64)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    x = torch.from_numpy(np.tile(base, (1000, 1))).cuda()
    qn = base[rng.integers(0, 32, Q)] + 0.3 * rng.standard_normal((Q, 64)).astype(np.float32)
    q = torch.from_numpy(qn.astype(np.float32)).cuda()
    s, i = sk.scan_topk(q, x, k)
    # the kernel's score of a distinct row, the same for all its copies
    per_row = sk.scan_topk(q, x[:32].contiguous(), 32)
    for r in range(Q):
        order = per_row[1][r].cpu().numpy()
        vals = per_row[0][r].cpu().numpy()
        assert len(set(vals.tolist())) == 32, "distinct rows should score apart"
        want = np.concatenate([u + 32 * np.arange(1000) for u in order])[:k]
        np.testing.assert_array_equal(i[r].cpu().numpy(), want)
        np.testing.assert_array_equal(s[r].cpu().numpy(), np.repeat(vals, 1000)[:k])


@pytest.mark.cuda
def test_a_batch_step_launches_twice():
    """``FlatIndex.search`` and serving qge1 over an f32 cosine gallery each
    take the kernel once."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    ix = build_flat(torch.randn(5000, 256, generator=g, device="cuda"), device="cuda")
    q = torch.randn(70, 256, generator=g, device="cuda")
    before = sk.launches
    _, ids = ix.search(q, 100)
    ranks = qge1(ids, None, ix.vectors, k=3, w=4.0, out_k=100)
    torch.cuda.synchronize()
    assert sk.launches == before + 2
    assert ranks.shape == (70, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "q_above", "k_above", "non_contiguous"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _card()
    q = torch.randn(8, 64, device="cuda")
    x = torch.randn(1000, 64, device="cuda")
    k = 10
    if case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "q_above":
        q = torch.randn(sk.MAX_Q + 1, 64, device="cuda")
    elif case == "k_above":
        k = sk.MAX_K + 1
    else:
        x = torch.randn(64, 1000, device="cuda").T
    assert not sk.takes(q, x, k)
    before = sk.launches
    with pytest.raises(ValueError, match="scan_topk"):
        sk.scan_topk(q, x, k)
    assert sk.launches == before
