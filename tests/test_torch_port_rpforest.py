"""The RP-forest (``index.rpforest``) of the port against the JAX package: every
build stage with JAX's draws substituted at the port's seam, the descent,
the candidate re-rank (duplicates, -1 padding and a union shorter than k),
search chunking, artifacts both ways, and ``matching_ANNOY``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import matchers as jm
from image_search_engine_for_historical_research_tpu.index import rpforest as jrp
from image_search_engine_for_historical_research_tpu.index import save_index as j_save_index
from image_search_engine_for_historical_research_tpu_torch.index import load_index, save_index
from image_search_engine_for_historical_research_tpu_torch.index import matchers as tm
from image_search_engine_for_historical_research_tpu_torch.index import rpforest as trp
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_arrays,
    jax_forest_draws,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[650:] = x[:50]                          # duplicate rows: tied scores
    q = (x[rng.choice(700, 12, replace=False)]
         + 0.05 * rng.standard_normal((12, 24))).astype(np.float32)
    return x, q


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(trp, "_level_draws", jax_forest_draws)


def test_split_levels_match_jax(data, jax_draws):
    """Each level of one tree down to segments of one or two rows (and empty
    ones): planes, including degenerate ones (a segment of one row, or two
    equal rows) replaced by the normal draw, thresholds and segment ids."""
    x, _ = data
    key = jax.random.split(jax.random.PRNGKey(7), 3)[1]
    seg_j = jnp.zeros((700,), jnp.int32)
    seg_t = torch.zeros(700, dtype=torch.long)
    replaced = 0
    for d in range(11):
        key, sub = jax.random.split(key)
        pj, tj, seg_j = jrp._median_split_level(jnp.asarray(x), seg_j, 1 << d, sub)
        draws = jax_forest_draws(7, 3, 1, d, 700, 1 << d, 24)
        pt, tt, seg_t = trp._median_split_level(torch.from_numpy(x), seg_t, 1 << d, draws)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
        replaced += int((pt == draws[2]).all(1).sum())
    assert replaced > 0


@pytest.mark.parametrize("n_trees, leaf_size", [(5, 64), (3, 700)])
def test_build_matches_jax(data, jax_draws, n_trees, leaf_size):
    """``build_rpforest`` with JAX's draws: planes (bf16 bits), thresholds,
    the leaf tables and the rows, array for array (``normalize=False``: each
    package's row norms differ in the last bit). ``leaf_size`` above N gives
    a one-level tree."""
    x, _ = data
    jix = jrp.build_rpforest(x, n_trees=n_trees, leaf_size=leaf_size, seed=3, normalize=False)
    tix = trp.build_rpforest(x, n_trees=n_trees, leaf_size=leaf_size, seed=3,
                             normalize=False, device="cpu")
    assert tix.depth == jix.depth
    assert_same_arrays(jix.to_arrays()[1], tix.to_arrays()[1], atol=1e-6)


def test_own_draws_build_a_balanced_forest(data):
    """Without the substitution: every row in one leaf a tree, leaves of
    balanced size, and each gallery row finds itself."""
    x, _ = data
    stats = {}
    ix = trp.build_rpforest(x, n_trees=4, leaf_size=64, device="cpu", stats=stats)
    assert set(stats) == {"trees", "leaves"}
    items = ix.leaf_items.numpy()
    for t in range(4):
        valid = items[t][items[t] >= 0]
        assert sorted(valid.tolist()) == list(range(700))
        sizes = (items[t] >= 0).sum(1)
        assert sizes.max() - sizes.min() <= 1
    _, ids = ix.search(x[:20], 5)
    assert (ids[:, 0].numpy() == np.arange(20)).all()


def test_descent_matches_jax(data):
    x, q = data
    jix = jrp.build_rpforest(x, n_trees=6, leaf_size=32, seed=1)
    tix = trp.RPForestIndex.from_arrays(*jix.to_arrays(), device="cpu")
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    want = jrp._descend(jix.planes, jix.thresholds, jnp.asarray(qn), jix.depth)
    got = trp._descend(tix.planes, tix.thresholds, torch.from_numpy(qn), tix.depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [5, 40])
def test_rerank_candidates_matches_jax(k):
    """Leaves with -1 padding and repeated ids; at k=40 the union (fewer than
    40 valid ids) is padded with the best id at -inf."""
    rng = np.random.default_rng(2)
    vectors = rng.standard_normal((30, 8)).astype(np.float32)
    leaf_items = rng.integers(-1, 30, (3, 4, 9)).astype(np.int32)
    leaf_items[:, :, 7:] = -1
    leaf_items[1, 2, :3] = [5, 5, 5]
    leaf = rng.integers(0, 4, (6, 3)).astype(np.int32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    sj, ij = jrp._rerank_candidates(jnp.asarray(vectors), jnp.asarray(leaf_items),
                                    jnp.asarray(leaf), jnp.asarray(q), k)
    st, it = trp._rerank_candidates(torch.from_numpy(vectors), torch.from_numpy(leaf_items),
                                    torch.from_numpy(leaf).long(), torch.from_numpy(q), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    if k == 40:
        assert np.isneginf(st.numpy()[:, -1]).all()


def test_search_chunking_matches_jax(data, monkeypatch):
    """Queries in chunks (JAX pads the last one with the first query, the
    port leaves it short): a patched gather budget (chunk 8 over 12 queries)
    and an explicit chunk of 5 give JAX's ids."""
    x, q = data
    jix = jrp.build_rpforest(x, n_trees=5, leaf_size=48, seed=2)
    tix = trp.RPForestIndex.from_arrays(*jix.to_arrays(), device="cpu")
    sj, ij = jix.search(jnp.asarray(q), 10)
    monkeypatch.setattr(trp, "GATHER_BYTES", 1)
    for chunk in (None, 5):
        st, it = tix.search(q, 10, query_chunk=chunk)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    s0, i0 = tix.search(q[:0], 10)
    assert i0.shape == (0, 10) and s0.shape == (0, 10)


def test_artifacts_both_ways(data, tmp_path):
    """The port loads JAX's artifact (bf16 planes as uint16, and the legacy
    f32 ``planes``), and JAX loads the port's."""
    x, q = data
    jix = jrp.build_rpforest(x, n_trees=3, leaf_size=64, seed=5)
    j_save_index(jix, str(tmp_path / "jax"))
    tix = load_index(str(tmp_path / "jax"), device="cpu")
    assert isinstance(tix, trp.RPForestIndex) and tix.planes.dtype == torch.bfloat16
    assert_same_arrays(jix.to_arrays()[1], tix.to_arrays()[1], atol=0)
    save_index(tix, str(tmp_path / "torch"))
    back = j_load_index(str(tmp_path / "torch"))
    assert_same_arrays(jix.to_arrays()[1], back.to_arrays()[1], atol=0)
    np.testing.assert_array_equal(np.asarray(back.search(jnp.asarray(q), 5)[1]),
                                  tix.search(q, 5)[1].numpy())

    meta, arrays = jix.to_arrays()
    legacy = dict(arrays)
    legacy["planes"] = np.asarray(jix.planes.astype(jnp.float32))
    del legacy["planes_bf16"]
    old = trp.RPForestIndex.from_arrays(meta, legacy, device="cpu")
    assert torch.equal(old.planes, tix.planes)


def test_matching_annoy_matches_jax(data, tmp_path, jax_draws):
    """``matching_ANNOY`` builds JAX's forest (draws substituted) and returns
    JAX's ids; with ``ifgenerate=False`` it reloads the artifact."""
    x, q = data
    ij, _ = jm.matching_ANNOY(10, x, q, dataset="d", n_trees=4, leaf_size=64,
                              outputs=str(tmp_path / "jax"))
    it, tpq = tm.matching_ANNOY(10, x, q, dataset="d", n_trees=4, leaf_size=64,
                                outputs=str(tmp_path / "torch"), device="cpu")
    assert it.dtype == np.int64 and tpq > 0
    np.testing.assert_array_equal(it, ij)
    again, _ = tm.matching_ANNOY(10, x, q, dataset="d", ifgenerate=False,
                                 outputs=str(tmp_path / "torch"), device="cpu")
    np.testing.assert_array_equal(again, ij)


@pytest.mark.cuda
def test_cuda_forest_matches_cpu(data):
    """On the card: a forest built from the same host draws equals the CPU's
    leaf tables, and its search the CPU's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, q = data
    cpu = trp.build_rpforest(x, n_trees=4, leaf_size=64, device="cpu")
    gpu = trp.build_rpforest(x, n_trees=4, leaf_size=64, device="cuda")
    np.testing.assert_array_equal(gpu.leaf_items.cpu().numpy(), cpu.leaf_items.numpy())
    np.testing.assert_array_equal(gpu.search(q, 10)[1].cpu().numpy(), cpu.search(q, 10)[1].numpy())
