"""Two faults of the port against the JAX package, repaired and pinned: the
feature store reads the reference's pickle store, and ``ops`` and
``models`` export every name JAX's ``ops`` and ``models`` do."""

import importlib
import os
import pickle

import numpy as np
import pytest

from image_search_engine_for_historical_research_tpu import ops as jops
from image_search_engine_for_historical_research_tpu.data import store as jstore
from image_search_engine_for_historical_research_tpu_torch import ops as tops
from image_search_engine_for_historical_research_tpu_torch.data import store as tstore


@pytest.mark.parametrize("layout", ["DxN", "NxD"])
def test_pickle_store_loads_alike_in_both_packages(tmp_path, layout):
    """The reference writes ``{'path': [...], 'feature': D x N}``; an N x D
    array loads as is. Either way (N, D) f32 rows, as JAX reads them."""
    rows = np.random.default_rng(0).standard_normal((5, 12))
    paths = [f"db/img{i}.jpg" for i in range(5)]
    os.makedirs(tmp_path / "features")
    with open(tmp_path / "features" / "db_path_feature.pkl", "wb") as f:
        pickle.dump({"feature": rows.T if layout == "DxN" else rows, "path": paths}, f)
    got, got_paths = tstore.load_path_features("db", root=str(tmp_path))
    want, want_paths = jstore.load_path_features("db", root=str(tmp_path))
    assert got.dtype == want.dtype == np.float32 and got.shape == (5, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rows.astype(np.float32))
    assert got_paths == want_paths == paths
    # the npz store, when present, wins over the pickle in both packages
    tstore.save_path_feature("db", rows[:2], paths[:2], root=str(tmp_path))
    assert tstore.load_path_features("db", root=str(tmp_path))[1] == paths[:2]
    assert jstore.load_path_features("db", root=str(tmp_path))[1] == paths[:2]
    with pytest.raises(FileNotFoundError):
        tstore.load_path_features("other", root=str(tmp_path))


def test_ops_exports_every_name_of_jax_ops():
    """JAX's whole ``ops.__all__`` is a subset of the port's, and every
    name imports."""
    missing = set(jops.__all__) - set(tops.__all__)
    assert not missing, missing
    for name in tops.__all__:
        assert getattr(importlib.import_module(tops.__name__), name) is not None, name
    from image_search_engine_for_historical_research_tpu_torch.ops import (  # noqa: F401
        int8_topk,
        sos_loss,
        whitenlearn,
    )


def test_models_exports_every_name_of_jax_models():
    """JAX's ``models.__all__`` is a subset of the port's (``FrozenBatchNorm``
    and ``convert_solar_state_dict`` name the port's ``FrozenBatchNorm2d``
    and ``to_flax_variables``), and every name imports."""
    from image_search_engine_for_historical_research_tpu import models as jmodels
    from image_search_engine_for_historical_research_tpu_torch import models as tmodels

    missing = set(jmodels.__all__) - set(tmodels.__all__)
    assert not missing, missing
    for name in tmodels.__all__:
        assert getattr(tmodels, name) is not None, name
    assert tmodels.FrozenBatchNorm is tmodels.FrozenBatchNorm2d
    assert tmodels.convert_solar_state_dict is tmodels.to_flax_variables
