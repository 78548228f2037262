"""PyTorch port vs JAX: normalization, pooling, exact scores, qge1, descent."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.ops import normalization as jnorm
from image_search_engine_for_historical_research_tpu.ops import pooling as jpool
from image_search_engine_for_historical_research_tpu.ops.graph_search import (
    hnsw_descend_entries as j_descend,
)
from image_search_engine_for_historical_research_tpu.rerank import qe as jqe
from image_search_engine_for_historical_research_tpu_torch.index import normalize_rows
from image_search_engine_for_historical_research_tpu_torch.ops import (
    exact_scores,
    gem,
    hnsw_descend_entries,
    l2n,
    mac,
    spoc,
)
from image_search_engine_for_historical_research_tpu_torch.rerank import qe as tqe

ATOL = 1e-6


@pytest.fixture(scope="module")
def fmap():
    """NHWC non-negative feature maps and a mask with a fully-masked row."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((3, 5, 7, 16))).astype(np.float32)
    mask = np.zeros((3, 5, 7), bool)
    mask[0] = True
    mask[1, :3, :4] = True          # row 2 stays fully masked
    return x, mask


@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_l2n(eps):
    x = np.random.default_rng(1).standard_normal((4, 33)).astype(np.float32)
    np.testing.assert_allclose(
        l2n(torch.from_numpy(x), eps=eps).numpy(),
        np.asarray(jnorm.l2n(jnp.asarray(x), eps=eps)), atol=ATOL,
    )


@pytest.mark.parametrize("p_kind", ["scalar", "per_channel"])
@pytest.mark.parametrize("masked", [False, True])
def test_gem(fmap, p_kind, masked):
    x, mask = fmap
    p = 3.0 if p_kind == "scalar" else (
        2.0 + np.random.default_rng(2).random(16)).astype(np.float32)
    m = mask if masked else None
    got = gem(torch.from_numpy(x), torch.as_tensor(p),
              mask=None if m is None else torch.from_numpy(m))
    want = jpool.gem(jnp.asarray(x), jnp.asarray(p), mask=None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if masked:  # the fully-masked row is floored at eps
        np.testing.assert_allclose(got[2].numpy(), 1e-6, rtol=1e-4)


@pytest.mark.parametrize("pool", ["mac", "spoc"])
@pytest.mark.parametrize("masked", [False, True])
def test_mac_spoc(fmap, pool, masked):
    x, mask = fmap
    x, mask = x[:2], mask[:2]       # MAC of a fully-masked row is -inf in both
    fn_t, fn_j = {"mac": (mac, jpool.mac), "spoc": (spoc, jpool.spoc)}[pool]
    got = fn_t(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None)
    want = fn_j(jnp.asarray(x), mask=jnp.asarray(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def gallery():
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((60, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = vecs[[3, 17, 40]] + 0.1 * rng.standard_normal((3, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ranks = np.argsort(-(q @ vecs.T), axis=1)[:, :10].astype(np.int32)
    return vecs, q, ranks


def test_exact_scores_and_normalize_rows(gallery):
    vecs, q, _ = gallery
    np.testing.assert_allclose(
        exact_scores(torch.from_numpy(q), torch.from_numpy(vecs)).numpy(), q @ vecs.T,
        atol=1e-5,
    )
    x = np.random.default_rng(4).standard_normal((5, 8)).astype(np.float32)
    from image_search_engine_for_historical_research_tpu.index.base import (
        normalize_rows as j_norm_rows,
    )

    np.testing.assert_allclose(normalize_rows(torch.from_numpy(x)).numpy(),
                               np.asarray(j_norm_rows(jnp.asarray(x))), atol=ATOL)


def test_qge1_topk_and_feature_enhancement(gallery):
    vecs, q, ranks = gallery
    got = tqe.qge1(torch.from_numpy(ranks), torch.from_numpy(q), torch.from_numpy(vecs),
                   k=3, out_k=5).numpy()
    want = np.asarray(jqe.qge1(jnp.asarray(ranks), jnp.asarray(q), jnp.asarray(vecs),
                               k=3, out_k=5))
    np.testing.assert_array_equal(got, want)
    qt, rt = tqe.feature_enhancement(torch.from_numpy(q), torch.from_numpy(vecs),
                                     torch.from_numpy(ranks), k=3, iterations=2)
    qj, rj = jqe.feature_enhancement(jnp.asarray(q), jnp.asarray(vecs),
                                     jnp.asarray(ranks), k=3, iterations=2)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=ATOL)
    np.testing.assert_array_equal(rt.numpy()[:, :10], np.asarray(rj)[:, :10])
    full = tqe.qge1(torch.from_numpy(ranks), torch.from_numpy(q), torch.from_numpy(vecs), k=3)
    assert full.shape == (3, 60)


def test_hnsw_descend_entries_matches_jax():
    from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build

    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    ix = j_build(x, m=6, ef_construction=24)
    want = np.asarray(j_descend(ix.vectors, ix.nbru, ix.entry, jnp.asarray(q)))
    got = hnsw_descend_entries(torch.from_numpy(np.asarray(ix.vectors).copy()),
                               torch.from_numpy(np.asarray(ix.nbru).copy()),
                               ix.entry, torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
