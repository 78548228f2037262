"""The regional descriptor of the port against the JAX package: ``powerlaw``,
``rmac`` and ``roipool`` (1e-6), the R-MAC grid over a sweep of map shapes,
the whitening functions (1e-5, eigenvector signs aligned), a regional
(Rpool) and an R-MAC ``SolarRetrieval`` with carried variables (1e-4), and
the regional weights carried both ways exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.models.weights import (
    convert_solar_state_dict,
)
from image_search_engine_for_historical_research_tpu.ops import normalization as jnorm
from image_search_engine_for_historical_research_tpu.ops import pooling as jpool
from image_search_engine_for_historical_research_tpu.ops import whiten as jwh
from image_search_engine_for_historical_research_tpu_torch.models import (
    SolarRetrieval,
    from_flax_variables,
    init_network,
    to_flax_variables,
)
from image_search_engine_for_historical_research_tpu_torch.ops import normalization as tnorm
from image_search_engine_for_historical_research_tpu_torch.ops import pooling as tpool
from image_search_engine_for_historical_research_tpu_torch.ops import whiten as twh
from torch_port_helpers import ONE_BLOCK, one_block_arch, perturbed_variables


def _maps(shape=(2, 9, 13, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_powerlaw_rmac_roipool_match_jax():
    x = _maps()
    np.testing.assert_allclose(tnorm.powerlaw(torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.powerlaw(jnp.asarray(x))), rtol=0, atol=1e-6)
    for shape in ((2, 9, 13, 16), (1, 12, 7, 8), (3, 5, 5, 4)):
        x = np.abs(_maps(shape, seed=len(shape) + shape[1]))
        np.testing.assert_allclose(tpool.rmac(torch.from_numpy(x)).numpy(),
                                   np.asarray(jpool.rmac(jnp.asarray(x))), rtol=0, atol=1e-6)
        for name in ("mac", "spoc"):
            want = jpool.roipool(jnp.asarray(x), getattr(jpool, name))
            got = tpool.roipool(torch.from_numpy(x), getattr(tpool, name))
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        want = jpool.roipool(jnp.asarray(x), lambda z: jpool.gem(z, 3.0))
        got = tpool.roipool(torch.from_numpy(x), lambda z: tpool.gem(z, 3.0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_rmac_grid_matches_jax():
    for H in range(1, 40, 3):
        for W in range(1, 40, 4):
            for L in (1, 3, 5):
                assert tpool._rmac_grid(H, W, L) == jpool._rmac_grid(H, W, L), (H, W, L)


def _align_rows(P_ref, P):
    """``P``'s rows with the signs of ``P_ref``'s (eigh's sign is free)."""
    return P * np.sign((P * P_ref).sum(1, keepdims=True))


def test_whitening_matches_jax():
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((120, 12)) @ np.diag(np.linspace(0.5, 3.0, 12))).astype(np.float32)
    mj, Pj = (np.asarray(a) for a in jwh.pcawhitenlearn(jnp.asarray(X)))
    mt, Pt = (a.numpy() for a in twh.pcawhitenlearn(torch.from_numpy(X)))
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)
    Pt = _align_rows(Pj, Pt)
    np.testing.assert_allclose(Pt, Pj, rtol=1e-4, atol=1e-5)
    for dims in (None, 5):
        want = np.asarray(jwh.whitenapply(jnp.asarray(X), jnp.asarray(mj), jnp.asarray(Pj),
                                          dimensions=dims))
        got = twh.whitenapply(torch.from_numpy(X), torch.from_numpy(mt),
                              torch.from_numpy(Pt.astype(np.float32)), dimensions=dims).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    qidx = np.arange(0, 60)
    pidx = qidx + 60
    X[60:] = X[:60] + 0.3 * rng.standard_normal((60, 12)).astype(np.float32)
    mj, Pj = (np.asarray(a) for a in jwh.whitenlearn(jnp.asarray(X), jnp.asarray(qidx),
                                                      jnp.asarray(pidx)))
    mt, Pt = (a.numpy() for a in twh.whitenlearn(torch.from_numpy(X), torch.from_numpy(qidx),
                                                 torch.from_numpy(pidx)))
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_align_rows(Pj, Pt), Pj, rtol=1e-4, atol=1e-4)


def test_psd_cholesky_jitter_ladder():
    """A rank-deficient S factors only with jitter: the first rung of the
    ladder that works, as in JAX."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 3)).astype(np.float32)
    S = A @ A.T
    want = np.asarray(jwh._psd_cholesky(jnp.asarray(S)))
    got = twh._psd_cholesky(torch.from_numpy(S)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def regional_nets():
    """A regional GeM net and an R-MAC net, JAX variables perturbed and
    carried into the port."""
    out = {}
    with one_block_arch():
        for name, params in (("regional", {"regional": True}), ("rmac", {"pooling": "rmac"})):
            jmodel = j_init({"architecture": ONE_BLOCK, **params})
            variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params),
                                            seed=len(name))
            tnet = SolarRetrieval(architecture=ONE_BLOCK, **params).eval()
            tnet.load_state_dict(from_flax_variables(variables), strict=True)
            out[name] = (jmodel, variables, tnet)
    return out


@pytest.mark.parametrize("name", ["regional", "rmac"])
def test_regional_descriptors_match_jax(regional_nets, name):
    jmodel, variables, tnet = regional_nets[name]
    images = np.random.default_rng(5).standard_normal((2, 160, 96, 3)).astype(np.float32)
    with one_block_arch():
        want = np.asarray(jmodel.module.apply(variables, jnp.asarray(images)))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_regional_masked_batch_raises(regional_nets):
    _, _, tnet = regional_nets["regional"]
    images = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="masked"):
        tnet(images, torch.ones((1, 64, 64), dtype=torch.bool))
    with pytest.raises(ValueError, match="regional base pooling"):
        SolarRetrieval(architecture=ONE_BLOCK, pooling="rmac", regional=True)


def test_regional_weights_carried_both_ways(regional_nets):
    """``pool.rpool.p`` and ``pool.whiten`` (Flax ``gem_p``, ``rwhiten``):
    the JAX converter and the port's own read the port's state_dict back
    into the same tree, and ``init_network`` builds the same layout."""
    _, variables, tnet = regional_nets["regional"]
    sd = tnet.state_dict()
    assert sd["pool.rpool.p"].shape == (1,) and sd["pool.whiten.weight"].shape == (2048, 2048)
    for conv in (convert_solar_state_dict, to_flax_variables):
        tree = conv(sd)
        np.testing.assert_array_equal(tree["params"]["rwhiten"]["kernel"],
                                      variables["params"]["rwhiten"]["kernel"])
        np.testing.assert_array_equal(tree["params"]["rwhiten"]["bias"],
                                      variables["params"]["rwhiten"]["bias"])
        np.testing.assert_array_equal(tree["params"]["gem_p"], variables["params"]["gem_p"])
    with one_block_arch():
        net = init_network({"architecture": ONE_BLOCK, "regional": True}, device="cpu")
    assert set(net.module.state_dict()) == set(sd)
    assert net.meta["regional"] is True
