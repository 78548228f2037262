"""PyTorch port vs JAX: the optimizer groups, the optimizer and its schedule
and accumulation, the train step's loss and gradients, and the backbone's
training knobs (``frozen_stages``, ``remat``, ``compute_dtype``).

Weights are carried across with ``from_flax_variables``; gradients are drawn
with numpy from a seed in the port's layout and carried to Flax's with
``to_flax_variables``, so both optimizers see the same sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.train import optim as j_optim
from image_search_engine_for_historical_research_tpu.train import step as j_step
from image_search_engine_for_historical_research_tpu_torch.models import (
    SolarRetrieval,
    from_flax_variables,
    to_flax_variables,
)
from image_search_engine_for_historical_research_tpu_torch.train import (
    apply_gradients,
    init_train_state,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    param_labels,
)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    ONE_BLOCK,
    one_block_arch,
    one_torch_thread,
    perturbed_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _port_to_flax_params(named: dict) -> dict:
    """{port parameter name: tensor} -> the Flax ``params`` tree."""
    return to_flax_variables(named)["params"]


def _torch_net(variables, **kw):
    net = SolarRetrieval(architecture=ONE_BLOCK, **kw)
    net.load_state_dict(from_flax_variables(variables), strict=True)
    return net


@pytest.fixture(scope="module")
def one_block():
    """Perturbed one-block ResNet101-SOLAR variables (numpy)."""
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=2)
        yield jmodel, variables


# --- parameter groups -------------------------------------------------------

@pytest.mark.parametrize("freeze", [True, False])
def test_param_labels_match_jax_name_for_name(one_block, freeze):
    _, variables = one_block
    with one_block_arch():
        net = _torch_net(variables)
    labels = param_labels(net, freeze_backbone=freeze)
    codes = {"frozen": 0, "gem_p": 1, "train": 2}
    # carry the labels through the weight converter as arrays of codes
    coded = {n: torch.full(p.shape, float(codes[labels[n]])) for n, p in net.named_parameters()}
    got = dict(_flax_leaves(_port_to_flax_params(coded)))
    want = dict(_flax_leaves(jax.tree.map(
        lambda s: np.float32(codes[s]),
        j_optim.param_labels(variables["params"], freeze_backbone=freeze))))
    assert set(got) == set(want)
    for path, code in want.items():
        assert np.all(got[path] == code), (path, got[path].flat[0], code)
    assert labels["pool.p"] == "gem_p"
    assert (labels["features.conv4_x.0.conv1.weight"] == "frozen") == freeze
    assert labels["features.soa4.f.0.weight"] == labels["features.conv5_x.0.conv1.weight"] == "train"


# --- the optimizer ----------------------------------------------------------

OPT_CASES = {
    "adamw": dict(lr=1e-3, weight_decay=1e-2),
    "adam_wd0": dict(lr=1e-3, weight_decay=0.0),
    "sgd_wd": dict(lr=1e-2, weight_decay=1e-2, optimizer="sgd"),
    "exp_decay": dict(lr=1e-3, weight_decay=1e-2, exp_decay=0.7, epochs_per_step=0.5),
    "update_every_3": dict(lr=1e-3, weight_decay=1e-2, exp_decay=0.7, epochs_per_step=0.5,
                           update_every=3),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(one_block, case):
    """Six steps of one gradient sequence through optax (``make_optimizer``,
    ``MultiSteps``) and through the port (``make_optimizer`` +
    ``apply_gradients``): every parameter at rtol 1e-5, frozen ones untouched,
    and the lr the schedule reached."""
    _, variables = one_block
    kw = dict(OPT_CASES[case])
    k = kw.pop("update_every", 1)
    with one_block_arch():
        net = _torch_net(variables)
    opt, sched, labels = make_optimizer(net, freeze_backbone=True, **kw)
    state = init_train_state(net, opt, sched, update_every=k)
    tx, _ = j_optim.make_optimizer(variables["params"], freeze_backbone=True, **kw)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    jp = jax.tree.map(jnp.asarray, variables["params"])
    jstate = tx.init(jp)
    rng = np.random.default_rng(11)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    for _ in range(6):
        g = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
             for n, s in shapes.items()}
        for n, p in net.named_parameters():
            if p.requires_grad:
                p.grad = g[n].clone() if p.grad is None else p.grad + g[n]
        apply_gradients(state)
        jg = jax.tree.map(jnp.asarray, _port_to_flax_params(g))
        updates, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)

    assert state.step == 6 and state.micro == 0
    got = dict(_flax_leaves(_port_to_flax_params(dict(net.named_parameters()))))
    want = dict(_flax_leaves(jax.tree.map(np.asarray, jp)))
    start = dict(_flax_leaves(variables["params"]))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-7, err_msg=str(path))
    frozen = [n for n, lab in labels.items() if lab == "frozen"]
    assert frozen and all(not net.get_parameter(n).requires_grad for n in frozen)
    path = ("features", "conv1", "kernel")
    np.testing.assert_array_equal(got[path], start[path])
    # the schedule ticked once per optimizer update, from the base lr
    n_updates = 6 // k
    factor = np.exp(-kw.get("exp_decay", 0.0) * n_updates * kw.get("epochs_per_step", 0.0))
    np.testing.assert_allclose(opt.param_groups[0]["lr"], kw["lr"] * factor, rtol=1e-12)
    np.testing.assert_allclose(opt.param_groups[1]["lr"], 100 * kw["lr"] * factor, rtol=1e-12)


def test_optimizer_groups():
    """``AdamW`` with decay, ``Adam`` without, ``gem_p`` at 100 x lr and no
    decay; an unknown optimizer raises."""
    net = SolarRetrieval(architecture="resnet50")
    opt, _, _ = make_optimizer(net, lr=1e-4, weight_decay=1e-3)
    assert type(opt) is torch.optim.AdamW
    assert [(g["lr"], g["weight_decay"]) for g in opt.param_groups] == [(1e-4, 1e-3),
                                                                      (1e-2, 0.0)]
    assert opt.param_groups[1]["params"] == [net.pool.p]
    opt, _, _ = make_optimizer(net, weight_decay=0.0, freeze_backbone=False)
    assert type(opt) is torch.optim.Adam
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == sum(
        p.numel() for p in net.parameters())
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(net, optimizer="lamb")


# --- the step: loss and gradients -------------------------------------------

@pytest.fixture(scope="module")
def resnet50():
    """resnet50 with SOA, perturbed variables and a 2-tuple batch at 64 px
    (nnum 2, so S = 4)."""
    jmodel = j_init({"architecture": "resnet50"}, rng=jax.random.PRNGKey(1))
    variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=3)
    rng = np.random.default_rng(4)
    S = 4
    images = rng.standard_normal((2 * S, 64, 64, 3)).astype(np.float32)
    labels = np.tile(np.array([-1, 1, 0, 0], np.int32), 2)
    return jmodel, variables, images, labels, S


def _jax_value_and_grad(jmodel, variables, images, labels, S, backbone_dtype=None):
    """JAX's loss (contrastive + 10 SOS) and parameter gradients; with
    ``backbone_dtype`` the backbone's variables and the images in that dtype
    (the head runs f32 in both packages whatever the backbone's dtype)."""
    loss_fn = j_step.make_loss_fn(jmodel.module, S, "contrastive", 0.7, lambda_sos=10.0)
    v = jax.tree.map(jnp.asarray, variables)
    x = jnp.asarray(images)
    if backbone_dtype is not None:
        for c in ("params", "batch_stats"):
            v[c] = dict(v[c])
            v[c]["features"] = jax.tree.map(lambda a: a.astype(backbone_dtype),
                                            v[c]["features"])
        x = x.astype(backbone_dtype)
    value, grads = jax.value_and_grad(lambda w: loss_fn(w, x, jnp.asarray(labels)))(v)
    return float(value), jax.tree.map(np.asarray, grads["params"])


def _port_grads(net, images, labels, S, lambda_sos=10.0):
    net.zero_grad(set_to_none=True)
    value = make_loss_fn(net, S, "contrastive", 0.7, lambda_sos=lambda_sos)(
        torch.from_numpy(images), torch.from_numpy(labels))
    value.backward()
    return value.detach(), {n: p.grad for n, p in net.named_parameters()}


def _trainable_net(variables, **kw):
    net = SolarRetrieval(architecture="resnet50", **kw)
    net.load_state_dict(from_flax_variables(variables), strict=True)
    return net.requires_grad_(True)


# f64: the backbone (and the images) in float64 in both packages. JAX still
# computes its SOA logits (``preferred_element_type=f32``) and its head in
# f32; the port computes both in f64 under an f64 backbone. So this case holds
# an all-f64 port against JAX's f32 parts, which set the 1e-4 limit.
# f32: everything f32; a reduction order that differs between XLA and torch
# moves a few leaves of the deep backbone by up to ~5e-4 of their norm.
GRAD_CASES = {"f64": (torch.float64, 1e-4), "f32": (None, 1e-3)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_gradients_match_jax(resnet50, case):
    """The loss at rtol 1e-5 and every parameter's gradient against
    ``jax.value_and_grad``, as the relative error of the leaf in norm
    (``||g - g_jax|| / ||g_jax||``; leaves JAX gives exactly zero are zero)."""
    jmodel, variables, images, labels, S = resnet50
    dtype, tol = GRAD_CASES[case]
    with jax.enable_x64(dtype is not None):
        jvalue, jgrads = _jax_value_and_grad(jmodel, variables, images, labels, S,
                                             jnp.float64 if dtype is not None else None)
    net = _trainable_net(variables)
    x = images
    if dtype is not None:
        net.features.to(dtype)
        x = images.astype(np.float64)
    value, grads = _port_grads(net, x, labels, S)
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-5)
    got = dict(_flax_leaves(_port_to_flax_params(grads)))
    want = dict(_flax_leaves(jgrads))
    assert set(got) == set(want)
    worst = (0.0, None)
    for path, w in want.items():
        norm = np.linalg.norm(w)
        err = np.linalg.norm(got[path] - w)
        if norm == 0:
            assert err == 0, path
            continue
        worst = max(worst, (err / norm, path))
    assert worst[0] <= tol, worst


def test_frozen_stages_stop_gradients(resnet50):
    """``frozen_stages=3``: no gradient reaches the stem or stages 1-3, and
    every other gradient is the unfrozen one."""
    _, variables, images, labels, S = resnet50
    net = _trainable_net(variables)
    v_full, full = _port_grads(net, images, labels, S)
    full = {n: g.clone() for n, g in full.items()}
    v_frozen, frozen = _port_grads(net.clone(frozen_stages=3), images, labels, S)
    assert float(v_frozen) == float(v_full)
    for name, g in frozen.items():
        if name.startswith(("features.conv1.", "features.conv2_x.", "features.conv3_x.",
                            "features.conv4_x.")):
            assert g is None, name
        else:
            torch.testing.assert_close(g, full[name], rtol=1e-6, atol=1e-9, msg=name)


def test_remat_gives_the_same_gradients(resnet50):
    _, variables, images, labels, S = resnet50
    net = _trainable_net(variables)
    v_full, full = _port_grads(net, images, labels, S)
    full = {n: g.clone() for n, g in full.items()}
    remat = net.clone(remat=True, frozen_stages=2)
    v_remat, got = _port_grads(remat, images, labels, S)
    assert float(v_remat) == float(v_full)
    for name, g in got.items():
        if name.startswith(("features.conv1.", "features.conv2_x.", "features.conv3_x.")):
            assert g is None, name
        else:
            torch.testing.assert_close(g, full[name], rtol=1e-6, atol=1e-9, msg=name)


def test_bf16_compute_gives_a_close_finite_loss(resnet50):
    _, variables, images, labels, S = resnet50
    net = _trainable_net(variables)
    f32, _ = _port_grads(net, images, labels, S)
    value, grads = _port_grads(net.clone(compute_dtype=torch.bfloat16, frozen_stages=3),
                               images, labels, S)
    assert torch.isfinite(value) and value.dtype == torch.float32
    np.testing.assert_allclose(float(value), float(f32), rtol=1e-2)
    assert all(g.dtype == torch.float32 for g in grads.values() if g is not None)


def test_clone_shares_parameters():
    net = SolarRetrieval(architecture="resnet50")
    c = net.clone(frozen_stages=3, remat=True, compute_dtype=torch.bfloat16)
    assert c.features.frozen_stages == 3 and net.features.frozen_stages == 0
    assert c.features.remat and not net.features.remat
    assert c.features.compute_dtype == torch.bfloat16 and net.features.compute_dtype is None
    assert all(a is b for a, b in zip(c.parameters(), net.parameters()))
    with pytest.raises(TypeError):
        net.clone(pooling="mac")


def test_train_step_moves_only_trainable_parameters(resnet50):
    """One call is one forward, backward and optimizer step: a 0-d loss, the
    frozen stages and the BN statistics unchanged, the head moved, and a
    second step on the same batch lowers the loss."""
    _, variables, images, labels, S = resnet50
    net = _trainable_net(variables)
    want, _ = _port_grads(net, images, labels, S)
    opt, sched, _ = make_optimizer(net, lr=1e-3, weight_decay=1e-6)
    state = init_train_state(net, opt, sched)
    step = make_train_step(net.clone(frozen_stages=3), S, lambda_sos=10.0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    state, loss1 = step(state, x, y)
    assert loss1.ndim == 0 and not loss1.requires_grad and state.step == 1
    assert float(loss1) == float(want)
    after = net.state_dict()
    for k in ("features.conv1.0.weight", "features.conv4_x.0.conv2.weight",
              "features.conv5_x.0.bn1.running_mean"):
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    assert not torch.equal(after["whiten.weight"], before["whiten.weight"])
    assert not torch.equal(after["pool.p"], before["pool.p"])
    _, loss2 = step(state, x, y)
    assert float(loss2) < float(loss1)
