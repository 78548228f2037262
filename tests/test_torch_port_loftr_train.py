"""The port's LoFTR trainer (``train.loftr``) against the JAX package's:
``random_homography``'s draws, the warp (1e-5), the ground-truth matrix and
both losses (1e-6), the AdamW schedule at every step of warmup and decay
against optax, one train step's loss and gradients (plain and ``accum=2``)
against JAX's in f32, one bf16 step's against JAX's bf16 step, steps that
keep the BN statistics frozen and follow JAX's losses, and the bf16 + remat
+ accum rung. JAX's test config (``tests/test_loftr_train.py``) at 32 x 48.
The JAX modules are imported inside the tests, so the file's ``cuda`` case
collects on a machine without Flax."""

import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu_torch.models import loftr as T
from image_search_engine_for_historical_research_tpu_torch.train import loftr as TL
from torch_port_helpers import jax_bf16_dots, perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4,
             coarse_layers=("self", "cross"), thr=0.0, max_matches=24)
H, W = 32, 48


def _jax():
    import jax

    from image_search_engine_for_historical_research_tpu.models import loftr as J
    from image_search_engine_for_historical_research_tpu.train import loftr as JL

    return jax, J, JL


def _batch(n=4, seed=1, jitter=0.05, hw=(H, W)):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n,) + hw + (1,)).astype(np.float32)
    Hs = np.stack([TL.random_homography(rng, *hw, jitter=jitter) for _ in range(n)])
    return imgs, Hs


@pytest.fixture(scope="module")
def jax_variables():
    import jax.numpy as jnp

    jax, J, _ = _jax()
    dummy = jnp.zeros((H, W, 1), jnp.float32)
    jv = jax.jit(J.LoFTRMatcher(J.LoFTRConfig(**SMALL)).init)(jax.random.PRNGKey(0), dummy,
                                                              dummy)
    return jax.tree.map(np.asarray, jv)


def _port(jv, dtype=torch.float32, **cfg):
    m = T.LoFTRMatcher(T.LoFTRConfig(**dict(SMALL, **cfg)))
    m.load_state_dict(T.from_flax_variables(jv, m.config))
    return m.to(dtype)


def test_random_homography_draws_as_jax():
    _, _, JL = _jax()
    for seed in (0, 3):
        np.testing.assert_array_equal(TL.random_homography(seed, 480, 640),
                                      JL.random_homography(seed, 480, 640))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(TL.random_homography(a, H, W, 0.1),
                                      JL.random_homography(b, H, W, 0.1))


def test_warp_gt_matrix_and_losses_match_jax():
    import jax.numpy as jnp

    jax, _, JL = _jax()
    imgs, Hs = _batch(3, seed=2, jitter=0.1)
    for img, Hm in zip(imgs, Hs):
        # an f32 ulp of a source coordinate (3.8e-6 px at x = 47) moves a
        # noise image's pixel by up to as much: JAX's own eager and jitted
        # warps differ by 3.1e-6, and the port (whose 3 x 3 inverse differs
        # from XLA's by an ulp) is held to 1e-5
        want = np.asarray(JL.warp_image(jnp.asarray(img), jnp.asarray(Hm)))
        own = np.abs(np.asarray(jax.jit(JL.warp_image)(jnp.asarray(img), jnp.asarray(Hm)))
                     - want).max()
        got = TL.warp_image(torch.from_numpy(img), torch.from_numpy(Hm)).numpy()
        assert own <= 1e-5 and np.abs(got - want).max() <= 1e-5, (np.abs(got - want).max(), own)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(
            TL.coarse_gt_matrix(torch.from_numpy(Hm), H // 8, W // 8, 8).numpy(),
            np.asarray(JL.coarse_gt_matrix(jnp.asarray(Hm), H // 8, W // 8, 8)))
    shift = np.array([[1, 0, 8], [0, 1, 0], [0, 0, 1]], np.float32)
    gt = TL.coarse_gt_matrix(torch.from_numpy(shift), 3, 4, 8).numpy()
    assert gt.sum() == 9 and gt[0, 1] and not gt[3].any()
    rng = np.random.default_rng(0)
    conf = rng.uniform(0, 0.3, (24, 24)).astype(np.float32) ** 3
    gt = rng.uniform(size=(24, 24)) < 0.05
    np.testing.assert_allclose(
        float(TL.coarse_focal_loss(torch.from_numpy(conf), torch.from_numpy(gt))),
        float(JL.coarse_focal_loss(jnp.asarray(conf), jnp.asarray(gt))), rtol=1e-6)
    k0 = rng.uniform(0, 40, (24, 2)).astype(np.float32)
    k1 = (k0 + rng.normal(0, 1.5, (24, 2))).astype(np.float32)
    c = np.where(rng.uniform(size=24) < 0.7, 0.1, 0.0).astype(np.float32)
    np.testing.assert_allclose(
        float(TL.fine_l2_loss(*map(torch.from_numpy, (k0, k1, c, Hs[0])), 4.0)),
        float(JL.fine_l2_loss(*map(jnp.asarray, (k0, k1, c, Hs[0])), 4.0)), rtol=1e-6)


@pytest.mark.parametrize("lr,warmup,decay", [(8e-3, 10, 20), (3e-4, 2, 10000), (1e-3, 0, 5)])
def test_schedule_matches_optax_at_every_step(lr, warmup, decay):
    import optax

    sched = optax.warmup_exponential_decay_schedule(
        init_value=lr / max(warmup, 1), peak_value=lr, warmup_steps=warmup,
        transition_steps=max(decay, 1), decay_rate=0.5)
    steps = range(0, warmup + 3 * decay + 2) if decay < 100 else range(0, 40)
    want = np.array([float(sched(s)) for s in steps], np.float32)
    got = np.array([TL.loftr_schedule(s, lr, warmup, decay) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = torch.nn.Linear(2, 2)
    opt, sch = TL.make_loftr_optimizer(m, lr, 0.1, warmup, decay)
    seen = []
    for _ in range(len(want)):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sch.step()
    np.testing.assert_allclose(np.array(seen, np.float32), want, rtol=1e-6)


def _jax_grads(jv, imgs, Hs, accum, compute_dtype=None):
    """Loss and gradients of JAX's train step, read from a transformation
    that keeps them as its state."""
    import jax.numpy as jnp
    import optax

    jax, J, JL = _jax()
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    state = JL.init_loftr_train_state(jv, keep)
    step = JL.make_loftr_train_step(J.LoFTRMatcher(J.LoFTRConfig(**SMALL)), keep, accum=accum,
                                    compute_dtype=compute_dtype)
    state, loss = step(state, jnp.asarray(imgs), jnp.asarray(Hs))
    return float(loss), jax.tree.map(np.asarray, state.opt_state)


def _leaf(jgrads, name):
    """JAX's gradient of the port's parameter ``name``, in the port's layout."""
    _, path, leaf = T._flax_path(name)
    for k in path:
        jgrads = jgrads[k]
    g = jgrads[leaf]
    return g.transpose(3, 2, 0, 1) if g.ndim == 4 else (g.T if g.ndim == 2 else g)


def _port_step(jv, imgs, Hs, **kw):
    """The port's loss and gradients of one step from ``jv``."""
    m = _port(jv)
    opt, sch = TL.make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
    state = TL.init_loftr_train_state(m, opt, sch)
    _, loss = TL.make_loftr_train_step(**kw)(state, torch.from_numpy(imgs), torch.from_numpy(Hs))
    return m, float(loss)


@pytest.mark.parametrize("accum", [None, 2])
def test_train_step_loss_and_gradients_match_jax(jax_variables, accum):
    """One step in f32 (JAX's step does not trace under ``enable_x64``: its
    fine-window ``dynamic_slice`` then mixes int32 and int64 start indices)
    at 64 x 96, where coarse matches clear the border and the fine loss has
    gradients (at 32 x 48 it has none): the loss within 1e-6, all the
    gradients together within 1e-4 of their norm (3.9e-5 seen) and each
    leaf within 5e-3 of its own (the fine attention's keys, whose gradient
    is 1e-4 of conv1's, at 1.4e-3; the median leaf at 3.4e-6)."""
    imgs, Hs = _batch(hw=(64, 96))
    jloss, jgrads = _jax_grads(jax_variables, imgs, Hs, accum)
    m, loss = _port_step(jax_variables, imgs, Hs, accum=accum)
    assert loss == pytest.approx(jloss, rel=1e-6)
    assert float(m.fine_preprocess.merge_feat.weight.grad.abs().max()) > 0
    diff = norm = 0.0
    for name, p in m.named_parameters():
        g = _leaf(jgrads, name)
        d = np.linalg.norm(p.grad.numpy() - g)
        assert d <= 5e-3 * np.linalg.norm(g), (name, d / np.linalg.norm(g))
        diff, norm = diff + d ** 2, norm + np.linalg.norm(g) ** 2
    assert (diff / norm) ** 0.5 <= 1e-4, (diff / norm) ** 0.5


def test_bf16_train_step_loss_and_gradients_match_jax(jax_variables):
    """One ``compute_dtype=bfloat16`` step against JAX's at 64 x 96, JAX's
    variables moved by seeded noise (random-init BN is the identity, in
    which no cast order shows). bf16 moves JAX's own loss and gradients
    from its f32 step, so the port's are held to JAX's bf16 step within
    that drift: the loss within JAX's bf16-to-f32 gap (0.71 of it seen;
    1.16 with the BN affine computed in f32 and then cast, the ResNet's
    order), all the gradients together within 0.7 of it (0.48 of it, 2.8%
    of their norm, seen; 1.13 in the ResNet's order) and each leaf within
    3x its own plus 1e-3 of its norm (0.55 of that at most; 0.94)."""
    import jax.numpy as jnp

    jv = perturbed_variables(jax_variables)
    imgs, Hs = _batch(hw=(64, 96))
    with jax_bf16_dots():
        jloss, jgrads = _jax_grads(jv, imgs, Hs, None, jnp.bfloat16)
    jloss32, j32 = _jax_grads(jv, imgs, Hs, None)
    m, loss = _port_step(jv, imgs, Hs, compute_dtype=torch.bfloat16)
    diff = drift = 0.0
    worst = 0.0
    for name, p in m.named_parameters():
        g, g32 = _leaf(jgrads, name), _leaf(j32, name)
        d, own = np.linalg.norm(p.grad.numpy() - g), np.linalg.norm(g - g32)
        worst = max(worst, d / (3 * own + 1e-3 * np.linalg.norm(g32)))
        diff, drift = diff + d ** 2, drift + own ** 2
    assert abs(loss - jloss) <= abs(jloss - jloss32), (loss, jloss, jloss32)
    assert diff ** 0.5 <= 0.7 * drift ** 0.5, (diff / drift) ** 0.5
    assert worst <= 1.0, worst


def test_steps_follow_jax_and_keep_bn_frozen(jax_variables):
    """Five f32 steps (lr 3e-4, warmup 2): the losses follow JAX's within
    1e-3 and fall, the BN statistics do not move, and the lr follows the
    schedule."""
    import jax.numpy as jnp

    jax, J, JL = _jax()
    imgs, Hs = _batch(2)
    tx = JL.make_loftr_optimizer(lr=3e-4, warmup_steps=2)
    jstate = JL.init_loftr_train_state(jax_variables, tx)
    jstep = JL.make_loftr_train_step(J.LoFTRMatcher(J.LoFTRConfig(**SMALL)), tx)
    m = _port(jax_variables)
    stats = {k: v.clone() for k, v in m.named_buffers()}
    opt, sch = TL.make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
    state = TL.init_loftr_train_state(m, opt, sch)
    step = TL.make_loftr_train_step()
    jl, tl = [], []
    for _ in range(5):
        jstate, loss = jstep(jstate, jnp.asarray(imgs), jnp.asarray(Hs))
        jl.append(float(loss))
        state, loss = step(state, torch.from_numpy(imgs), torch.from_numpy(Hs))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] and state.step == 5
    for k, v in m.named_buffers():
        assert torch.equal(v, stats[k]), k
    assert opt.param_groups[0]["lr"] == pytest.approx(TL.loftr_schedule(5, 3e-4, 2), rel=1e-6)


def test_bf16_remat_accum_rung_trains_and_remat_keeps_gradients(jax_variables):
    imgs, Hs = _batch(4)
    grads = []
    for remat in (False, True):
        m = _port(jax_variables, remat=remat)
        opt, sch = TL.make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
        state = TL.init_loftr_train_state(m, opt, sch)
        TL.make_loftr_train_step()(state, torch.from_numpy(imgs), torch.from_numpy(Hs))
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)

    m = _port(jax_variables, remat=True)
    opt, sch = TL.make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
    state = TL.init_loftr_train_state(m, opt, sch)
    step = TL.make_loftr_train_step(compute_dtype=torch.bfloat16, accum=2)
    losses = [float(step(state, torch.from_numpy(imgs), torch.from_numpy(Hs))[1])
              for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(ValueError, match="not divisible"):
        TL.make_loftr_train_step(accum=3)(state, torch.from_numpy(imgs), torch.from_numpy(Hs))


@pytest.mark.cuda
def test_cuda_step_equals_the_cpu_in_f64():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    imgs, Hs = _batch()
    out = {}
    for dev in ("cpu", "cuda"):
        m = T.init_matcher(device=dev, **SMALL).double()
        opt, sch = TL.make_loftr_optimizer(m)
        state = TL.init_loftr_train_state(m, opt, sch)
        _, loss = TL.make_loftr_train_step()(state, torch.from_numpy(imgs).double(),
                                             torch.from_numpy(Hs))
        out[dev] = float(loss), {n: p.grad.cpu() for n, p in m.named_parameters()}
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-6)
    for n, g in out["cpu"][1].items():
        assert float((out["cuda"][1][n] - g).norm() / g.norm().clamp(min=1e-30)) <= 1e-4, n

