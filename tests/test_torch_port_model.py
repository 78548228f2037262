"""PyTorch port vs JAX: SOLAR weights carried both ways, and the descriptor.

The architecture is ResNet101-SOLAR at full width with one bottleneck per
stage (``torch_port_helpers.ONE_BLOCK``), with every weight and BN statistic
perturbed, so SOA attention takes part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.models import extract as jextract
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.models.weights import (
    convert_solar_state_dict,
)
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.models import (
    DEFAULT_SCALES,
    SolarRetrieval,
    from_flax_variables,
    multiscale_descriptor,
    to_flax_variables,
)
from torch_port_helpers import ONE_BLOCK, one_block_arch, perturbed_variables


@pytest.fixture(scope="module")
def nets():
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=1)
        tnet = SolarRetrieval(architecture=ONE_BLOCK).eval()
        tnet.load_state_dict(from_flax_variables(variables), strict=True)
        yield jmodel, variables, tnet


def _assert_trees_equal(a, b, path=()):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], path + (k,))
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape, (path + (k,), x.shape, y.shape)
            np.testing.assert_array_equal(x, y, err_msg=str(path + (k,)))


def test_weights_carried_both_ways_exactly(nets):
    _, variables, tnet = nets
    sd = tnet.state_dict()
    assert sd["pool.p"].shape == (1,)
    assert sd["features.soa4.v.weight"].abs().sum() > 0   # perturbed, SOA active
    # the JAX converter reads the port's state_dict back into the same tree
    _assert_trees_equal(convert_solar_state_dict(sd), variables)
    # the port's own copy of the converter agrees with it
    _assert_trees_equal(to_flax_variables(sd), variables)


def test_checkpoint_loads_strictly(nets, tmp_path):
    """A checkpoint in the reference layout (``meta`` + ``state_dict``, with
    BatchNorm's ``num_batches_tracked``) loads through ``load_network``."""
    _, _, tnet = nets
    sd = dict(tnet.state_dict())
    sd["features.conv1.1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "net.pth"
    torch.save({"state_dict": sd, "meta": {"architecture": ONE_BLOCK, "pooling": "gem"}}, path)
    with one_block_arch():
        model = load_network(str(path), device="cpu")
    got = model.module.state_dict()
    for k, v in tnet.state_dict().items():
        assert torch.equal(got[k], v), k
    assert model.outputdim == 2048


def _batch():
    """A masked batch of three images of different sizes on one canvas."""
    rng = np.random.default_rng(2)
    images = np.zeros((3, 96, 128, 3), np.float32)
    mask = np.zeros((3, 96, 128), bool)
    for b, (h, w) in enumerate([(96, 128), (70, 101), (96, 64)]):
        images[b, :h, :w] = rng.standard_normal((h, w, 3))
        mask[b, :h, :w] = True
    return images, mask


def test_multiscale_descriptor_matches_jax(nets):
    """Three scales (1, sqrt 2, 1/sqrt 2), masked mixed sizes, f32 on CPU: the
    sums run in a different order, hence 1e-4 on unit-norm descriptors."""
    jmodel, variables, tnet = nets
    images, mask = _batch()
    with one_block_arch():
        want = np.asarray(jextract.multiscale_descriptor(
            jmodel.module, variables, jnp.asarray(images), jnp.asarray(mask),
            scales=DEFAULT_SCALES,
        ))
    with torch.inference_mode():
        got = multiscale_descriptor(tnet, torch.from_numpy(images),
                                    torch.from_numpy(mask), scales=DEFAULT_SCALES).numpy()
    assert got.shape == (3, 2048)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_unmasked_descriptor_matches_jax(nets):
    jmodel, variables, tnet = nets
    images, _ = _batch()
    with one_block_arch():
        want = np.asarray(jmodel.module.apply(variables, jnp.asarray(images[:1])))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(images[:1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_compute_dtype_close_to_f32(nets):
    """``compute_dtype=bfloat16`` runs the backbone in bf16 (weights stay f32
    in the state_dict) and keeps the descriptor close to the f32 one."""
    _, _, tnet = nets
    bnet = SolarRetrieval(architecture=ONE_BLOCK, compute_dtype=torch.bfloat16).eval()
    bnet.load_state_dict(tnet.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in bnet.parameters())
    images, mask = _batch()
    with torch.inference_mode():
        want = tnet(torch.from_numpy(images), torch.from_numpy(mask))
        got = bnet(torch.from_numpy(images), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    cos = (got * want).sum(1)
    assert (cos > 0.99).all(), cos
