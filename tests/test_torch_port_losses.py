"""PyTorch port vs JAX: the tuple losses (contrastive, triplet, SOS) and the
training half of soft PQ, values and gradients on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.ops import losses as jlosses
from image_search_engine_for_historical_research_tpu.ops import softpq as jsoftpq
from image_search_engine_for_historical_research_tpu_torch.ops import losses as tlosses
from image_search_engine_for_historical_research_tpu_torch.ops import softpq as tsoftpq

LOSSES = {
    "contrastive": dict(margin=0.7),
    "triplet": dict(margin=0.1),
    "sos": dict(),
}


def _tuples(nq, S, D=32, seed=0):
    """Unit descriptors of ``nq`` tuples of ``S`` images, positives near
    their query (some contrastive margins active, some not)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nq, S, D)).astype(np.float32)
    x[:, 1] = x[:, 0] + 0.3 * rng.standard_normal((nq, D))
    x = x.reshape(nq * S, D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    label = np.tile(np.array([-1, 1] + [0] * (S - 2), np.int32), nq)
    return x.astype(np.float32), label


def _jax_loss(name, S):
    fn = {"contrastive": jlosses.contrastive_loss, "triplet": jlosses.triplet_loss,
          "sos": jlosses.sos_loss}[name]
    return lambda x, label: fn(x, label, S=S, **LOSSES[name])


def _torch_loss(name, S):
    fn = {"contrastive": tlosses.contrastive_loss, "triplet": tlosses.triplet_loss,
          "sos": tlosses.sos_loss}[name]
    return lambda x, label: fn(x, label, S=S, **LOSSES[name])


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("nq,S", [(2, 7), (5, 4), (3, 5)])
def test_loss_value(name, nq, S):
    x, label = _tuples(nq, S, seed=nq * 10 + S)
    want = float(_jax_loss(name, S)(jnp.asarray(x), jnp.asarray(label)))
    got = float(_torch_loss(name, S)(torch.from_numpy(x), torch.from_numpy(label)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("nq,S", [(2, 7), (5, 4)])
def test_loss_gradient(name, nq, S):
    x, label = _tuples(nq, S, seed=nq * 10 + S + 1)
    want = np.asarray(jax.grad(_jax_loss(name, S))(jnp.asarray(x), jnp.asarray(label)))
    xt = torch.from_numpy(x).requires_grad_(True)
    _torch_loss(name, S)(xt, torch.from_numpy(label)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_tuple_size_read_from_labels():
    """Without ``S`` both packages read it from the labels (the queries)."""
    x, label = _tuples(3, 6, seed=4)
    for name, jfn, tfn in (("contrastive", jlosses.contrastive_loss, tlosses.contrastive_loss),
                           ("sos", jlosses.sos_loss, tlosses.sos_loss)):
        want = float(jfn(jnp.asarray(x), jnp.asarray(label)))
        got = float(tfn(torch.from_numpy(x), torch.from_numpy(label)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_contrastive_eps_inside_the_difference():
    """``d = ||q - o + eps||``: identical query and positive still give a
    positive distance, eps * sqrt(D), as in the reference."""
    D = 16
    x = np.zeros((3, D), np.float32)
    x[:, 0] = 1.0
    x[2] = -x[2]
    label = np.array([-1, 1, 0], np.int32)
    got = float(tlosses.contrastive_loss(torch.from_numpy(x), torch.from_numpy(label),
                                         eps=1e-3))
    want = float(jlosses.contrastive_loss(jnp.asarray(x), jnp.asarray(label), eps=1e-3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, 0.5 * D * 1e-6, rtol=1e-4)     # the negative is past the margin


# --- soft PQ, the training half -------------------------------------------------

@pytest.fixture
def jax_init(monkeypatch):
    """Route the port's codeword draw through JAX's ``PRNGKey(seed)`` draw."""
    def draw(shape, seed):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))

    monkeypatch.setattr(tsoftpq, "_normal_draw", draw)


@pytest.mark.parametrize("dim,M,Ks,seed", [(64, 8, 16, 3), (48, 4, 32, 0)])
def test_init_softpq_matches_jax_draw(jax_init, dim, M, Ks, seed):
    want = np.asarray(jsoftpq.init_softpq(dim, M, Ks, key=jax.random.PRNGKey(seed)).codewords)
    got = tsoftpq.init_softpq(dim, M, Ks, seed=seed, device="cpu").codewords
    assert got.requires_grad and got.shape == (M, Ks, dim // M)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tau", [1.0, 5.0])
def test_soft_quantize_and_loss_match_jax(jax_init, tau):
    dim, M, Ks = 64, 8, 16
    x = np.random.default_rng(5).standard_normal((40, dim)).astype(np.float32) * 0.3
    jstate = jsoftpq.init_softpq(dim, M, Ks, key=jax.random.PRNGKey(2))
    tstate = tsoftpq.init_softpq(dim, M, Ks, seed=2, device="cpu")
    jq, jsoft, jhard = jsoftpq.soft_quantize(jstate, jnp.asarray(x), tau)
    tq, tsoft, thard = tsoftpq.soft_quantize(tstate, torch.from_numpy(x), tau)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsoft.detach().numpy(), np.asarray(jsoft), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(thard.numpy(), np.asarray(jhard))

    jloss, (jg_cw, jg_x) = jax.value_and_grad(
        lambda s, v: jsoftpq.softpq_loss(s, v, tau), argnums=(0, 1))(jstate, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tloss = tsoftpq.softpq_loss(tstate, xt, tau)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tstate.codewords.grad.numpy(), np.asarray(jg_cw.codewords),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-5, atol=1e-6)


def test_softpq_training_lowers_distortion(jax_init):
    """A few Adam steps on the codewords lower the loss, and the hard codes
    stay the nearest codewords (``ops.pq``'s assignment)."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((256, 32)).astype(np.float32))
    state = tsoftpq.init_softpq(32, M=4, Ks=8, seed=1, device="cpu")
    opt = torch.optim.Adam([state.codewords], lr=0.05)
    first = None
    for _ in range(30):
        opt.zero_grad()
        loss = tsoftpq.softpq_loss(state, x, tau=5.0)
        loss.backward()
        opt.step()
        first = float(loss) if first is None else first
    assert float(tsoftpq.softpq_loss(state, x, tau=5.0)) < 0.9 * first
    _, _, hard = tsoftpq.soft_quantize(state, x)
    cw = state.codewords.detach()
    d2 = ((x.reshape(256, 4, 1, 8) - cw[None]) ** 2).sum(-1)
    torch.testing.assert_close(hard, d2.argmin(-1))
