"""The port's batch-sharded steps in a gloo world of 2 on the CPU, held
against the port's unsharded functions and against the JAX package's on its
virtual CPU mesh (``tests/conftest.py``): ``make_sharded_extract_fn``,
``extract_vectors(pad_batches=True)``, ``make_sharded_sift_fn``,
``make_train_step`` / ``make_grad_fn`` and ``make_loftr_train_step`` with
``mesh=``, and ``cli.extract_1m --mesh`` (in the world of 2, and in a world
of one in this process).

One module fixture spawns the world once (``tests/torch_port_parallel_steps_worker.py``,
a ``file://`` rendezvous, one torch thread a rank); each rank runs every case
and writes its results. The SOLAR weights are those of JAX's parity test,
carried in with ``from_flax_variables``; the LoFTR weights are the port's,
carried out with JAX's converter. The limits are JAX's own (``tests/test_parallel.py``,
``tests/test_loftr_train.py``) for sharded against unsharded, and the
port's established port-against-JAX limits where a result is held to JAX.
JAX's mesh has as many devices as the batch allows: 8, or 4 where a 12-image
batch must split, or 2 for a padded batch of 4.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from PIL import Image
from scipy import ndimage

from image_search_engine_for_historical_research_tpu import models as jmodels
from image_search_engine_for_historical_research_tpu import parallel as jparallel
from image_search_engine_for_historical_research_tpu.models import loftr as jloftr
from image_search_engine_for_historical_research_tpu.models.extract import (
    extract_vectors as j_extract_vectors,
)
from image_search_engine_for_historical_research_tpu.models.retrieval import (
    RetrievalModel as JRetrievalModel,
)
from image_search_engine_for_historical_research_tpu.models.retrieval import (
    SolarRetrieval as JSolarRetrieval,
)
from image_search_engine_for_historical_research_tpu.ops import sift as jsift
from image_search_engine_for_historical_research_tpu.train import loftr as jtrain_loftr
from image_search_engine_for_historical_research_tpu.train import step as jstep
from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.data import load_path_features
from image_search_engine_for_historical_research_tpu_torch.data import store as tstore
from image_search_engine_for_historical_research_tpu_torch.models import (
    extract_vectors,
    from_flax_variables,
    make_extract_fn,
    make_sharded_extract_fn,
    to_flax_variables,
)
from image_search_engine_for_historical_research_tpu_torch.models import loftr as tloftr
from image_search_engine_for_historical_research_tpu_torch.ops import make_sharded_sift_fn
from image_search_engine_for_historical_research_tpu_torch.ops import sift as tsift
from image_search_engine_for_historical_research_tpu_torch.train import (
    init_loftr_train_state,
    make_grad_fn,
    make_loftr_optimizer,
    make_loftr_train_step,
    make_train_step,
)
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)
import torch_port_parallel_steps_worker as worker

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2
N_CLI = 7
JAX_DEVICES = {"sos": 8, "straddle": 4, "triplet": 4}
# The triplet case's gradients are held to the unsharded port's only: on
# this batch the unsharded port's own triplet gradient lies up to 251x
# JAX's per-leaf limit from JAX's (1.35e-3 of the whole gradient's norm).
# The random-weight descriptors are nearly parallel, so the hinge's
# gradient is a difference of nearly equal terms, and the last-bit
# differences of the two backbones grow by that cancellation. Its loss is
# held to JAX's.
GRADS_HELD_TO_JAX = {"sos": True, "straddle": True, "triplet": False}


def _write_jpgs(directory, sizes, seed):
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    names = []
    for i, (h, w) in enumerate(sizes):
        low = rng.uniform(0, 255, (4, 5, 3)).astype(np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))
        names.append(f"d{i}.jpg")
        Image.fromarray(arr).save(os.path.join(directory, names[-1]), quality=92)
    return names


def _sift_images():
    """``tests/test_parallel.py``'s 8 smooth 128 x 128 images."""
    rng = np.random.default_rng(2)
    imgs = []
    for _ in range(8):
        base = ndimage.zoom(rng.uniform(0, 1, (16, 16)), 8, order=3)
        imgs.append(((base - base.min()) / (np.ptp(base) + 1e-9)).astype(np.float32))
    return np.stack(imgs)


def make_world_inputs(d):
    """Everything the ranks read first, written to ``d``; returns what the
    tests need on this side (JAX's modules, the inputs). The LoFTR weights
    are the port's seeded ones, carried to JAX by JAX's converter (exact
    both ways; a jitted JAX ``init`` costs 8 s)."""
    ns = SimpleNamespace(dir=d)
    ns.jmodule = JSolarRetrieval(architecture="resnet50")
    ns.lcfg = jloftr.LoFTRConfig(**worker.LOFTR_SMALL)
    matcher = tloftr.init_matcher(seed=0, device="cpu", **worker.LOFTR_SMALL)
    torch.save(matcher.state_dict(), d / "loftr.pt")
    ns.lvars = jloftr.convert_loftr_state_dict(matcher.state_dict(), ns.lcfg)

    rng = np.random.default_rng(8)
    inp = {"extract_images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
           "extract_mask": np.ones((8, 32, 32), bool), "sift_images": _sift_images()}
    for i, case in enumerate(worker.SOLAR_CASES):
        S, tuples = worker.SOLAR_CASES[case][:2]
        inp[f"solar_{case}_images"] = np.random.default_rng(7 + i).standard_normal(
            (S * tuples, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(1)
    inp["loftr_imgs"] = rng.uniform(0, 1, (8, 32, 48, 1)).astype(np.float32)
    inp["loftr_Hs"] = np.stack([jtrain_loftr.random_homography(rng, 32, 48, jitter=0.05)
                                for _ in range(8)])
    np.savez(d / "inputs.npz", **inp)
    ns.inputs = inp
    ns.pad_paths = [str(d / "pad" / n) for n in _write_jpgs(d / "pad", [(40, 48)] * 5, 4)]
    jpg = d / "revisitop1m" / "jpg"
    names = _write_jpgs(jpg, [(64, 80) if i % 2 else (96, 72) for i in range(N_CLI)], 0)
    with open(d / "revisitop1m" / "revisitop1m.txt", "w") as f:
        f.write("\n".join(names))
    return ns


class World:
    """The spawned ranks; ``result(rank)`` waits for them once. The results
    load lazily (rank 0's gradients are large)."""

    def __init__(self, ns):
        self.ns = ns
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_port_parallel_steps_worker.py"),
             str(r), str(WORLD), str(ns.dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
        self._results = None

    def result(self, rank=0):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    out, err = p.communicate(timeout=400)
                    logs.append(f"rc {p.returncode}\n{out[-2000:]}\n{err[-4000:]}")
            finally:
                self.close()
            assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)
            self._results = [np.load(self.ns.dir / f"rank{r}.npz") for r in range(WORLD)]
        return self._results[rank]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def write_solar_checkpoint(ns):
    """The weights of JAX's sharded parity test (``tests/test_parallel.py``:
    ``init_network({"architecture": "resnet50"}, rng=PRNGKey(0))``, as a
    jitted ``init``), carried into the port's checkpoint with
    ``from_flax_variables`` and written atomically: the ranks wait for it
    after their SIFT and LoFTR cases."""
    jv = jax.jit(ns.jmodule.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    ns.jvars = jax.tree.map(np.array, jv)            # writable copies
    tmp = ns.dir / "solar_ckpt.tmp"
    torch.save({"state_dict": from_flax_variables(ns.jvars),
                "meta": {"architecture": "resnet50"}}, tmp)
    os.replace(tmp, ns.dir / "solar_ckpt.pth")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(make_world_inputs(tmp_path_factory.mktemp("steps2")))
    try:
        write_solar_checkpoint(w.ns)
        yield w
    finally:
        w.close()


@pytest.fixture(scope="module")
def port_net(world):
    return load_network(str(world.ns.dir / "solar_ckpt.pth"), device="cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def assert_leaves_close(got, want, label):
    """JAX's sharded-gradient limit (``tests/test_parallel.py``): each leaf
    within ``max(1e-4 * max|want|, 1e-7)``."""
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        atol = max(1e-4 * float(np.abs(w).max()), 1e-7)
        np.testing.assert_allclose(got[k], w, atol=atol, err_msg=f"{label} {k}")


# --- the LoFTR step ------------------------------------------------------------

def _port_loftr(ns):
    m = tloftr.LoFTRMatcher(tloftr.LoFTRConfig(**worker.LOFTR_SMALL))
    m.load_state_dict(torch.load(ns.dir / "loftr.pt"))
    return m


@pytest.fixture(scope="module")
def jax_loftr_loss(world):
    """JAX's 8-device step's loss (``tests/test_loftr_train.py``'s sharded
    case): the mean over the 8 pairs, which ``accum`` does not change (JAX's
    ``test_accum_matches_full_batch`` holds the two within rel 1e-5), so
    both cases are held to it."""
    ns = world.ns
    mesh = jparallel.data_mesh(8)
    tx = jtrain_loftr.make_loftr_optimizer(lr=3e-4, warmup_steps=2)
    jstate = jax.device_put(jtrain_loftr.init_loftr_train_state(ns.lvars, tx),
                            NamedSharding(mesh, P()))
    step = jtrain_loftr.make_loftr_train_step(jloftr.LoFTRMatcher(ns.lcfg), tx, mesh=mesh)
    _, loss = step(jstate, jparallel.shard_batch(jnp.asarray(ns.inputs["loftr_imgs"]), mesh),
                   jparallel.shard_batch(jnp.asarray(ns.inputs["loftr_Hs"]), mesh))
    return float(loss)


@pytest.mark.parametrize("case", list(worker.LOFTR_CASES))
def test_sharded_loftr_step_matches_unsharded_and_jax(world, jax_loftr_loss, case):
    """``tests/test_loftr_train.py``'s case (the small config at 32 x 48, 8
    pairs, 4 a rank): the loss within rel 1e-4 of the unsharded port's and
    of JAX's 8-device step (``accum=2``: 2 micro-batches of 2 pairs a rank);
    the gradients together within 1e-4 of their norm of the unsharded
    port's (the port's LoFTR gradient limit against JAX)."""
    ns = world.ns
    accum = worker.LOFTR_CASES[case]
    imgs, Hs = ns.inputs["loftr_imgs"], ns.inputs["loftr_Hs"]
    m = _port_loftr(ns)
    opt, sch = make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
    _, loss = make_loftr_train_step(accum=accum)(init_loftr_train_state(m, opt, sch), t(imgs),
                                                 t(Hs))
    got = world.result()
    sharded = float(got[f"loftr_{case}_loss"])
    assert sharded == pytest.approx(float(loss), rel=1e-4)
    assert sharded == pytest.approx(jax_loftr_loss, rel=1e-4)
    prefix = f"rank_g0_loftr_{case}/"
    diff = norm = 0.0
    for name, p in m.named_parameters():
        g = p.grad.numpy()
        diff += float(np.sum((got[prefix + name] - g) ** 2))
        norm += float(np.sum(g ** 2))
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-4, (diff / norm) ** 0.5


def test_loftr_accum_must_divide_the_pairs_of_a_rank(world):
    """6 pairs over 2 ranks are 3 a rank, which ``accum=2`` does not divide:
    a ``ValueError`` that names both (JAX asks only that 2 divide 6; the
    port keeps the peak at ``accum`` pairs a card)."""
    msg = str(world.result()["loftr_accum_error"])
    assert "not divisible" in msg and "3 pairs a rank" in msg and "accum=2" in msg, msg


# --- the SOLAR step ------------------------------------------------------------

def _jax_value_and_grad(ns, case):
    """JAX's ``value_and_grad`` of its loss on its mesh, as its sharded
    parity test takes it (the batch sharded, the variables replicated)."""
    S, tuples, loss, margin, lam = worker.SOLAR_CASES[case]
    mesh = jparallel.data_mesh(JAX_DEVICES[case])
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    vg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(ns.jmodule, S, loss, margin, lam)),
                 in_shardings=(repl, shard, shard, shard), out_shardings=(repl, repl))
    x = ns.inputs[f"solar_{case}_images"]
    value, grads = vg(ns.jvars, jnp.asarray(x), jnp.asarray(worker.solar_labels(S, tuples)),
                      jnp.ones(x.shape[:3], bool))
    return float(value), dict(_flax_leaves(jax.tree.map(np.asarray, grads["params"])))


@pytest.mark.parametrize("case", list(worker.SOLAR_CASES))
def test_sharded_solar_step_matches_unsharded_and_jax(world, port_net, case):
    """The global-batch loss and gradient over 2 ranks, from the weights of
    JAX's parity test: ``sos`` is that test's case (S=3, 8 tuples,
    contrastive + 0.1 SOS); ``straddle`` (S=4, 3 tuples: tuple 1 lies
    across both ranks) and ``triplet`` (S=4, 3 tuples, the triplet loss)
    put a tuple across the ranks. The loss within rtol 1e-5 and every
    gradient leaf within ``1e-4 * max|g|`` (JAX's limits) of the unsharded
    port's and of JAX's sharded ``value_and_grad`` (the gradients of
    ``triplet``: of the unsharded port's, ``GRADS_HELD_TO_JAX``)."""
    ns = world.ns
    jvalue, jgrads = _jax_value_and_grad(ns, case)
    S, tuples, loss, margin, lam = worker.SOLAR_CASES[case]
    x = ns.inputs[f"solar_{case}_images"]
    module = port_net.module.requires_grad_(True)
    module.zero_grad(set_to_none=True)
    value = make_grad_fn(module, S, loss, margin, lam)(
        t(x), t(worker.solar_labels(S, tuples)), torch.ones(x.shape[:3], dtype=torch.bool))
    plain = {n: p.grad.numpy().copy() for n, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)

    got = world.result()
    loss_sharded = float(got[f"solar_{case}_loss"])
    np.testing.assert_allclose(loss_sharded, float(value), rtol=1e-5)
    np.testing.assert_allclose(loss_sharded, jvalue, rtol=1e-5)
    prefix = f"rank_g0_{case}/"
    grads = {k[len(prefix):]: got[k] for k in got.files if k.startswith(prefix)}
    assert_leaves_close(grads, plain, f"{case} sharded vs unsharded")
    if GRADS_HELD_TO_JAX[case]:
        assert_leaves_close(dict(_flax_leaves(to_flax_variables(grads)["params"])), jgrads,
                            f"{case} sharded vs JAX")


def test_sharded_train_step_keeps_every_rank_in_step(world):
    """Two sharded steps of a frozen clone with ``update_every=2`` (the
    running mean folds in the global gradient): the parameters moved, to
    the same bits on both ranks (``test_every_rank_returns_the_same_result``
    holds the digests equal), with finite losses."""
    got = world.result()
    assert bool(got["solar_step_moved"])
    assert np.isfinite(got["solar_step_losses"]).all()
    assert got["solar_step_param_digest"] == world.result(1)["solar_step_param_digest"]


def test_sharded_steps_refuse_a_non_mesh(port_net):
    """A ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError`` when the
    function is made, as the sharded builds do."""
    for make in (lambda: make_sharded_extract_fn(port_net.module, "data"),
                 lambda: make_sharded_sift_fn(object()),
                 lambda: make_train_step(port_net.module, 3, mesh=8),
                 lambda: make_loftr_train_step(mesh="data")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make()


# --- SIFT --------------------------------------------------------------------

def test_sharded_sift_matches_unsharded_and_jax(world):
    """``tests/test_parallel.py``'s 8 images of 128 x 128 (128 keypoints, 3
    octaves): every field within rtol / atol 1e-5 of the unsharded port
    (JAX's own sharded limit), and JAX's 8-device SIFT at the port's SIFT
    limits against JAX (``tests/test_torch_port_sift.py``: ``valid`` equal,
    ``xy`` and ``scale`` within 1e-3 px, ``angle`` and ``desc`` within
    1e-4); a wrong ``hw`` raises."""
    imgs = world.ns.inputs["sift_images"]
    jout = jsift.make_sharded_sift_fn(jparallel.data_mesh(8), imgs.shape[1:],
                                      **worker.SIFT_KW)(jnp.asarray(imgs))
    plain = tsift.sift_program(t(imgs), 3, tsift.default_budgets(128, 3))
    got = world.result()
    assert {f"sift_{k}" for k in plain} <= set(got.files)
    for k, v in plain.items():
        np.testing.assert_allclose(got[f"sift_{k}"], v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    j = {k: np.asarray(v) for k, v in jout.items()}
    np.testing.assert_array_equal(got["sift_valid"], j["valid"])
    for k, atol in (("xy", 1e-3), ("scale", 1e-3), ("desc", 1e-4)):
        np.testing.assert_allclose(got[f"sift_{k}"], j[k], rtol=0, atol=atol, err_msg=k)
    da = (got["sift_angle"] - j["angle"] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(da).max() <= 1e-4
    assert bool(got["sift_hw_raised"])


# --- extraction ---------------------------------------------------------------

def test_sharded_extraction_matches_unsharded_and_jax(world, port_net):
    """``tests/test_parallel.py``'s case: resnet50 at 32 x 32, 8 images, one
    scale; 2e-5 against the unsharded port, the descriptor limit 1e-4
    against JAX's 8-device extraction. A ``shard_batch`` input gives the
    same rows; 3 rows over 2 ranks raise."""
    ns = world.ns
    x, m = ns.inputs["extract_images"], ns.inputs["extract_mask"]
    jv = jmodels.make_sharded_extract_fn(ns.jmodule, jparallel.data_mesh(8), scales=(1.0,))(
        ns.jvars, jnp.asarray(x), jnp.asarray(m))
    got = world.result()
    plain = make_extract_fn(port_net.module, scales=(1.0,))(t(x), t(m)).numpy()
    np.testing.assert_allclose(got["extract_v"], plain, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["extract_v"], np.asarray(jv), rtol=0, atol=1e-4)
    assert bool(got["extract_from_shard_batch_equal"])
    assert bool(got["extract_indivisible_raised"])


def test_extract_vectors_pads_partial_batches(world, port_net):
    """5 images at batch size 4: the second batch is padded to 4 with
    all-masked canvases (every call splits over the 2 ranks), and the rows
    are the unpadded extraction's and JAX's padded sharded extraction's."""
    ns = world.ns
    jmodel = JRetrievalModel(module=ns.jmodule, params=ns.jvars, meta={"outputdim": 2048})
    jfn = jmodels.make_sharded_extract_fn(ns.jmodule, jparallel.data_mesh(2), scales=(1.0,))
    want_jax = j_extract_vectors(jmodel, ns.pad_paths, 48, batch_size=worker.PAD_BATCH,
                                 extract_fn=jfn, pad_batches=True)
    got = world.result()
    assert got["pad_batch_sizes"].tolist() == [4, 4]
    plain = extract_vectors(port_net, ns.pad_paths, 48, batch_size=worker.PAD_BATCH)
    assert np.isfinite(got["pad_rows"]).all() and got["pad_rows"].shape == (5, 2048)
    np.testing.assert_allclose(got["pad_rows"], plain, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["pad_rows"], want_jax, rtol=0, atol=1e-4)


# --- cli.extract_1m --mesh -------------------------------------------------------

def _cli(ns, out, *extra):
    return extract_1m.main(worker.cli_argv(ns.dir, out, *extra))


@pytest.fixture(scope="module")
def unsharded_rows(world, tmp_path_factory):
    """The unsharded CLI's store over the layout: the rows every mesh run
    must give (within JAX's sharded-extraction limit, 2e-5)."""
    out = tmp_path_factory.mktemp("cli_plain")
    assert _cli(world.ns, out) == 0
    rows, paths = load_path_features("revisitop1m", root=str(out))
    assert rows.shape == (N_CLI, 2048) and len(paths) == N_CLI
    return rows


def test_cli_mesh_writes_from_rank_zero_only(world, unsharded_rows):
    """In the world of 2: rank 0 wrote the checkpoint, the store and every
    shard and removed the checkpoint, rank 1 nothing; both resumed at the
    same rows (after the 4 sentinel rows of a checkpoint; at 0 and 4 in the
    shard runs); the stores hold the unsharded rows."""
    r0, r1 = world.result(0), world.result(1)
    checkpoints, stores, shards, removed = r0["rank_cli_writes"].tolist()
    assert checkpoints == 1 and stores == 1 and shards == 3 and removed == 1
    assert r1["rank_cli_writes"].tolist() == [0, 0, 0, 0]
    assert r0["cli_resume_points"].tolist() == [0, 4]
    assert bool(r0["cli_still_initialized"])
    rows, _ = load_path_features("revisitop1m", root=str(world.ns.dir / "cli_oneshot"))
    np.testing.assert_array_equal(rows[:4], np.full((4, 2048), 0.125, np.float32))
    np.testing.assert_allclose(rows[4:], unsharded_rows[4:], rtol=0, atol=2e-5)
    assert not os.path.exists(world.ns.dir / "cli_oneshot" / "revisitop1m_partial.npz")
    chunks_fn, n = tstore.chunked_feature_source("revisitop1m",
                                                 root=str(world.ns.dir / "cli_shards"))
    assert n == N_CLI
    np.testing.assert_allclose(np.concatenate(list(chunks_fn())), unsharded_rows, rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("mode", ["checkpoint", "shards"])
def test_cli_mesh_in_a_world_of_one(world, unsharded_rows, tmp_path, mode):
    """``--mesh --device cpu`` with no group running starts a gloo world of
    one in this process and ends it; interrupted and resumed in either
    mode, its store equals the unsharded run's."""
    ns = world.ns
    assert not dist.is_initialized()
    if mode == "checkpoint":
        assert _cli(ns, tmp_path, "--mesh", "--limit", "4") == 0
        first, _ = load_path_features("revisitop1m", root=str(tmp_path))
        np.savez(tmp_path / "revisitop1m_partial.npz",
                 vecs=np.concatenate([first, np.zeros((N_CLI - 4, 2048), np.float32)]), done=4)
        assert _cli(ns, tmp_path, "--mesh") == 0
        got, _ = load_path_features("revisitop1m", root=str(tmp_path))
        assert not os.path.exists(tmp_path / "revisitop1m_partial.npz")
    else:
        assert _cli(ns, tmp_path, "--mesh", "--shard-size", "3", "--limit", "4") == 0
        assert tstore.shard_resume_point("revisitop1m", root=str(tmp_path)) == 4
        assert _cli(ns, tmp_path, "--mesh", "--shard-size", "3") == 0
        chunks_fn, _ = tstore.chunked_feature_source("revisitop1m", root=str(tmp_path))
        got = np.concatenate(list(chunks_fn()))
    assert not dist.is_initialized()
    np.testing.assert_allclose(got, unsharded_rows, rtol=0, atol=2e-5)


# --- every rank (last: the tests above overlap JAX's work with the world's) ----

def test_every_rank_returns_the_same_result(world):
    r0, r1 = world.result(0), world.result(1)
    shared = sorted(k for k in r0.files if not k.startswith("rank_"))
    assert shared == sorted(k for k in r1.files if not k.startswith("rank_"))
    for k in shared:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
