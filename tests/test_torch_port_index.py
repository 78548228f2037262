"""HNSW index artifacts shared by both packages, and the port's index surface."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.index import build_hnsw as j_build
from image_search_engine_for_historical_research_tpu.index import load_index as j_load
from image_search_engine_for_historical_research_tpu.index import save_index as j_save
from image_search_engine_for_historical_research_tpu.index.base import (
    normalize_rows as j_normalize_rows,
)
from image_search_engine_for_historical_research_tpu.ops.graph_search import (
    hnsw_search_batch as j_search_batch,
)
from image_search_engine_for_historical_research_tpu_torch.index import (
    HNSWIndex,
    build_hnsw,
    load_index,
    save_index,
)
from torch_port_helpers import assert_same_beams


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(11)
    return rng.standard_normal((300, 32)).astype(np.float32)


def _assert_same_arrays(a, b):
    (ma, aa), (mb, ab) = a.to_arrays(), b.to_arrays()
    assert ma == mb
    assert set(aa) == set(ab)
    for k in aa:
        np.testing.assert_array_equal(np.asarray(aa[k]), np.asarray(ab[k]), err_msg=k)


def test_jax_artifact_loads_in_port(vecs, tmp_path):
    jix = j_build(vecs, m=8, ef_construction=32)
    j_save(jix, str(tmp_path / "hnsw"))
    tix = load_index(str(tmp_path / "hnsw"), device="cpu")
    assert isinstance(tix, HNSWIndex) and tix.device.type == "cpu"
    assert tix.coarse_ids is not None
    _assert_same_arrays(jix, tix)


def test_port_artifact_loads_in_jax(vecs, tmp_path):
    tix = build_hnsw(vecs, m=8, ef_construction=32, device="cpu")
    save_index(tix, str(tmp_path / "hnsw"))
    jix = j_load(str(tmp_path / "hnsw"))
    _assert_same_arrays(tix, jix)
    # both packages' searches agree on the port-built graph
    q = vecs[:4] + 0.01
    sj, ij = jix.search_pallas(jnp.asarray(q), 5, ef=32, interpret=True)
    st, it = tix.search(q, 5, ef=32)
    assert_same_beams(sj, ij, st, it)


def test_port_index_surface(vecs):
    tix = build_hnsw(vecs, m=8, ef_construction=32, device="cpu")
    # use_kernel=False is the lockstep traversal, the JAX default route
    q = tix.vectors[:4].numpy() + 0.01
    sj, ij = j_search_batch(jnp.asarray(tix.vectors.numpy()), jnp.asarray(tix.nbr0.numpy()),
                            jnp.asarray(tix.nbru.numpy()), tix.entry,
                            j_normalize_rows(jnp.asarray(q)), 5, 32,
                            coarse_ids=jnp.asarray(tix.coarse_ids.numpy()))
    st, it = tix.search(q, 5, ef=32, use_kernel=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    # without coarse ids the entry points come from the greedy descent
    no_coarse = HNSWIndex(tix.vectors, tix.nbr0, tix.nbru, tix.entry, tix.ef_default)
    s, i = no_coarse.search(torch.from_numpy(vecs[:3]), 5)
    assert i.shape == (3, 5)
    np.testing.assert_array_equal(i[:, 0].numpy(), [0, 1, 2])   # each finds itself
    assert (np.diff(s.numpy(), axis=1) <= 0).all()


def test_unported_kind_raises(tmp_path):
    """Every kind the JAX package writes is registered; an unknown kind
    raises, naming the registered ones."""
    import json
    import os

    from image_search_engine_for_historical_research_tpu.index.base import _REGISTRY as j_kinds
    from image_search_engine_for_historical_research_tpu_torch.index.base import _REGISTRY

    assert set(j_kinds) <= set(_REGISTRY)
    os.makedirs(tmp_path / "unknown")
    with open(tmp_path / "unknown" / "manifest.json", "w") as f:
        json.dump({"format_version": 1, "kind": "no_such_kind", "meta": {}}, f)
    np.savez(tmp_path / "unknown" / "arrays.npz", x=np.zeros(1))
    with pytest.raises(ValueError, match="unknown index kind 'no_such_kind'.*rpforest"):
        load_index(str(tmp_path / "unknown"), device="cpu")
