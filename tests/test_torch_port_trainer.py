"""PyTorch port vs JAX: tuple mining, the ``Trainer`` loop, its checkpoints
and resume, the retrieval eval (with ``--test-whiten``), ``cli.train``, and
the closed-loop guard (training raises mAP).

The models are resnet50 at 64 px with JAX's random-init variables carried
into the port with ``from_flax_variables``; the data are the synthetic
fixtures of ``data/synthetic.py`` (the JAX package's copy writes them here;
the port's own copy writes the same files).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu import train as jtrain
from image_search_engine_for_historical_research_tpu.cli import common as j_common
from image_search_engine_for_historical_research_tpu.cli import train as j_cli_train
from image_search_engine_for_historical_research_tpu.data import synthetic as jsynth
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.models.extract import (
    extract_vectors as j_extract_vectors,
)
from image_search_engine_for_historical_research_tpu_torch import train as ttrain
from image_search_engine_for_historical_research_tpu_torch.cli import common as t_common
from image_search_engine_for_historical_research_tpu_torch.cli import train as t_cli_train
from image_search_engine_for_historical_research_tpu_torch.data import synthetic as tsynth
from image_search_engine_for_historical_research_tpu_torch.models import (
    from_flax_variables,
    init_network,
)
from image_search_engine_for_historical_research_tpu_torch.models.extract import (
    extract_vectors as t_extract_vectors,
)
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_model(variables, meta):
    model = init_network({"architecture": meta["architecture"], "whitening": meta["whitening"]},
                         device="cpu")
    model.module.load_state_dict(from_flax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three folder classes of four 64 px images, resnet50 variables in both
    packages."""
    root = tmp_path_factory.mktemp("port_trainer")
    db_paths, _ = jsynth.make_folder_dataset(str(root / "data"), n_classes=3, per_class=4,
                                             size=(64, 64), seed=1)
    jmodel = j_init({"architecture": "resnet50"}, rng=jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, jmodel.params)
    return root, db_paths, jmodel, variables


def _cfg(mod, root, name, **kw):
    base = dict(epochs=1, lr=1e-4, image_size=64, nnum=2, batch_tuples=2, qsize=8,
                poolsize=12, checkpoint_dir=str(root / name), val_fraction=0.25,
                exp_decay=0.0)
    base.update(kw)
    return mod.TrainConfig(**base)


# --- synthetic fixtures and datasets ----------------------------------------

def test_synthetic_copy_writes_the_same_files(tmp_path):
    """The port's ``data/synthetic.py`` writes JAX's files byte for byte."""
    for mod, side in ((jsynth, "jax"), (tsynth, "torch")):
        mod.make_folder_dataset(str(tmp_path / side / "f"), n_classes=2, per_class=2,
                                size=(32, 48), seed=3)
        mod.make_scene_sfm_dataset(str(tmp_path / side / "s"), n_scenes=2, views_per_scene=2,
                                   canvas=(48, 64), crop=(32, 48), seed=4)
        mod.make_scene_revisited(str(tmp_path / side / "r"), n_scenes=2, db_views=2,
                                 canvas=(48, 64), crop=(32, 48), seed=5)
        mod.make_revisited_dataset(str(tmp_path / side / "v"), n_classes=2, per_class=2,
                                   size=(32, 32), seed=6)
        mod.make_sfm_db_dataset(str(tmp_path / side / "d"), n_clusters=2, per_cluster=2,
                                size=(32, 32), seed=7)
    files = {}
    for side in ("jax", "torch"):
        base = tmp_path / side
        files[side] = {os.path.relpath(os.path.join(d, f), base): open(os.path.join(d, f),
                                                                         "rb").read()
                       for d, _, fs in os.walk(base) for f in fs}
    assert files["jax"].keys() == files["torch"].keys() and len(files["jax"]) > 20
    for name, data in files["jax"].items():
        if name.endswith(".pkl"):
            assert repr(pickle.loads(data)).replace(str(tmp_path / "jax"), "") == repr(
                pickle.loads(files["torch"][name])).replace(str(tmp_path / "torch"), ""), name
        else:
            assert files["torch"][name] == data, name


def test_db_pickles_resolve_like_jax(tmp_path):
    pkl = jsynth.make_sfm_db_dataset(str(tmp_path), n_clusters=3, per_cluster=3, seed=2)
    for mode in ("train", "val"):
        a = jtrain.tuples_from_db_pickle(pkl, mode=mode, qsize=5, poolsize=7, nnum=2)
        b = ttrain.tuples_from_db_pickle(pkl, mode=mode, qsize=5, poolsize=7, nnum=2)
        assert list(a.images) == list(b.images)
        for f in ("cluster", "qpool", "ppool"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.qsize, a.poolsize, a.nnum) == (b.qsize, b.poolsize, b.nnum)
    db = {"cids": ["abcdef", "123456"], "qidxs": [0], "pidxs": [1]}
    wp = tmp_path / "retrieval-SfM-120k-whiten.pkl"
    with open(wp, "wb") as f:
        pickle.dump(db, f)
    a, b = jtrain.whiten_db_from_pickle(str(wp)), ttrain.whiten_db_from_pickle(str(wp))
    assert a["images"] == b["images"] and b["images"][0].endswith("ef/cd/ab/abcdef")
    with pytest.raises(ValueError, match="mode"):
        ttrain.tuples_from_db_pickle(pkl, mode="test")


def test_batch_tuples_layout(setup):
    _, db_paths, _, _ = setup
    tuples = [ttrain.TupleSpec(0, 1, [4, 8]), ttrain.TupleSpec(2, 3, [5, 9]),
              ttrain.TupleSpec(6, 7, [0, 10])]
    got = list(ttrain.batch_tuples(tuples, lambda i: np.full((2, 2, 3), i, np.float32), 2))
    want = list(jtrain.batch_tuples(
        [jtrain.TupleSpec(t.query, t.positive, t.negatives) for t in tuples],
        lambda i: np.full((2, 2, 3), i, np.float32), 2))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], [-1, 1, 0, 0, -1, 1, 0, 0])
    assert got[0][2] == 4 and list(ttrain.batch_tuples([], None, 2)) == []


# --- mining -----------------------------------------------------------------

@pytest.mark.parametrize("nnum", [1, 2])
def test_mine_epoch_gives_jax_tuples(setup, nnum):
    """From the same weights and the same generator both packages mine the
    same tuples, and every tuple keeps the reference's rules."""
    _, db_paths, jmodel, variables = setup
    tmodel = _port_model(variables, jmodel.meta)
    jds, tds = jtrain.tuples_from_folders(db_paths), ttrain.tuples_from_folders(db_paths)
    np.testing.assert_array_equal(jds.ppool, tds.ppool)
    jds.nnum = tds.nnum = nnum
    jt = jds.mine_epoch(lambda p: j_extract_vectors(jmodel, p, 64, batch_size=4),
                        np.random.default_rng(5))
    tt = tds.mine_epoch(lambda p: t_extract_vectors(tmodel, p, 64, batch_size=4),
                        np.random.default_rng(5), device="cpu")
    assert len(tt) == len(jt) > 0
    assert [(t.query, t.positive, t.negatives) for t in tt] == [
        (t.query, t.positive, t.negatives) for t in jt]
    for t in tt:
        negc = [tds.cluster[n] for n in t.negatives]
        assert tds.cluster[t.query] == tds.cluster[t.positive] not in negc
        assert len(set(negc)) == len(negc) == nnum


# --- the loop ---------------------------------------------------------------

def _record_steps(trainer):
    """Wrap ``trainer.step_fn`` to record each step's loss."""
    losses, step = [], trainer.step_fn

    def rec(state, *a, **k):
        state, loss = step(state, *a, **k)
        losses.append(float(loss))
        return state, loss

    trainer.step_fn = rec
    return losses


@pytest.fixture(scope="module")
def epoch_runs(setup):
    """One epoch of each package's ``Trainer`` from the same weights and
    seed, with every step's loss recorded."""
    root, db_paths, jmodel, variables = setup
    jm = j_init({"architecture": "resnet50"}, rng=jax.random.PRNGKey(0))
    jtr = jtrain.Trainer(jm, jtrain.tuples_from_folders(db_paths), _cfg(jtrain, root, "j_run"))
    j_losses = _record_steps(jtr)
    jhist = jtr.fit(log=None)
    ttr = ttrain.Trainer(_port_model(variables, jmodel.meta), ttrain.tuples_from_folders(db_paths),
                         _cfg(ttrain, root, "t_run"))
    t_losses = _record_steps(ttr)
    thist = ttr.fit(log=None)
    return (jhist, j_losses), (ttr, thist, t_losses)


def test_trainer_epoch_matches_jax(setup, epoch_runs):
    """The same mined tuples and crops: step losses at rtol 1e-3, the
    validation loss too, and the checkpoint files and sidecars."""
    root = setup[0]
    (jhist, j_losses), (ttr, thist, t_losses) = epoch_runs
    assert len(t_losses) == len(j_losses) > 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    np.testing.assert_allclose(thist[0].val_loss, jhist[0].val_loss, rtol=1e-3)
    assert thist[0].n_tuples == jhist[0].n_tuples
    for name in ("train_meta.json", "best.json", "metrics.jsonl", "epoch_0.pth"):
        assert os.path.exists(root / "t_run" / name), name
    meta = json.load(open(root / "t_run" / "train_meta.json"))
    assert meta["epoch"] == 0 and meta["meta"]["architecture"] == "resnet50"
    assert ttr.metrics.read()[0]["step_losses"] == t_losses


def test_checkpoint_serves_in_both_packages(setup, epoch_runs):
    """The port's checkpoint (the reference's torch dict, SOLAR layout) loads
    through JAX's ``load_network`` and the port's, and both give the trained
    port model's descriptors."""
    root, db_paths, jmodel, variables = setup
    ttr = epoch_runs[1][0]
    ckpt = root / "t_run" / "epoch_0.pth"
    trained = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert set(trained) >= {"epoch", "meta", "state_dict", "optimizer"}
    jnet = j_common.load_network(str(ckpt), "resnet50")
    tnet = t_common.load_network(str(ckpt), "resnet50", device="cpu")
    want = t_extract_vectors(ttr.model, db_paths[:5], 64, batch_size=4)
    np.testing.assert_allclose(j_extract_vectors(jnet, db_paths[:5], 64, batch_size=4), want,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_extract_vectors(tnet, db_paths[:5], 64, batch_size=4), want)
    # training moved the weights away from the start
    start = _port_model(variables, jmodel.meta)
    assert not np.allclose(t_extract_vectors(start, db_paths[:5], 64, batch_size=4), want,
                           atol=1e-7)


@pytest.mark.parametrize("update_every", [1, 2])
def test_resume_restores_the_optimizer_and_continues_exactly(setup, update_every):
    """``resume()`` brings back the weights, the Adam moments, the schedule,
    the accumulation state and the mining generator: a run stopped after
    epoch 0 and resumed gives the uninterrupted run's epoch-1 step losses."""
    root, db_paths, jmodel, variables = setup
    name = f"resume_{update_every}"
    kw = dict(epochs=2, batch_tuples=1, update_every=update_every, exp_decay=0.5)
    full = ttrain.Trainer(_port_model(variables, jmodel.meta),
                          ttrain.tuples_from_folders(db_paths),
                          _cfg(ttrain, root, name + "_full", **kw))
    full_losses = _record_steps(full)
    full.fit(log=None)

    first = ttrain.Trainer(_port_model(variables, jmodel.meta),
                           ttrain.tuples_from_folders(db_paths),
                           _cfg(ttrain, root, name, **dict(kw, epochs=1)))
    first_losses = _record_steps(first)
    first.fit(log=None)
    n0 = len(first_losses)
    if update_every == 2:
        assert first.state.micro == n0 % 2

    resumed = ttrain.Trainer(init_network({"architecture": "resnet50"}, seed=9, device="cpu"),
                             ttrain.tuples_from_folders(db_paths), _cfg(ttrain, root, name, **kw))
    assert resumed.resume() and resumed.start_epoch == 1
    for a, b in zip(first.model.module.state_dict().values(),
                    resumed.model.module.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    sa, sb = first.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and len(sa["state"]) > 0
    for k in sa["state"]:
        for f in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb["state"][k][f], sa["state"][k][f], rtol=0, atol=0)
    assert resumed.state.scheduler.last_epoch == first.state.scheduler.last_epoch
    assert (resumed.state.step, resumed.state.micro) == (first.state.step, first.state.micro)
    assert resumed.state.acc.keys() == first.state.acc.keys()
    assert resumed.history[0].epoch == 0 and resumed.best_val == first.best_val

    resumed_losses = _record_steps(resumed)
    resumed.fit(log=None)
    assert full_losses[:n0] == first_losses
    np.testing.assert_allclose(resumed_losses, full_losses[n0:], rtol=1e-6)


def test_trainer_knobs_reach_the_training_clone(setup):
    root, db_paths, jmodel, variables = setup
    tr = ttrain.Trainer(_port_model(variables, jmodel.meta), ttrain.tuples_from_folders(db_paths),
                        _cfg(ttrain, root, "knobs", compute_dtype="bfloat16", remat=True))
    feats = tr.train_module.features
    assert feats.frozen_stages == 3 and feats.remat and feats.compute_dtype == torch.bfloat16
    assert feats.conv1 is tr.model.module.features.conv1
    assert tr.model.module.features.frozen_stages == 0
    assert tr.model.module.features.compute_dtype is None


# --- the eval hook and the CLI ----------------------------------------------

def _folder_eval(db_paths):
    labels = [p.split("/")[-2] for p in db_paths]
    uniq = sorted(set(labels))
    gnd = [{"easy": np.array([i for i, l in enumerate(labels) if l == u]),
            "hard": np.empty(0, np.int64), "junk": np.empty(0, np.int64)} for u in uniq]
    return {"synth": {"images": db_paths, "qimages": [db_paths[labels.index(u)] for u in uniq],
                      "gnd": gnd}}, labels, uniq


def test_retrieval_eval_with_whitening_matches_jax(setup, tmp_path):
    """``make_retrieval_eval`` with a ``--test-whiten`` db: the same mAP rows
    as JAX's from the same weights."""
    _, db_paths, jmodel, variables = setup
    datasets, labels, uniq = _folder_eval(db_paths)
    qidxs, pidxs = [], []
    for u in uniq:
        members = [i for i, l in enumerate(labels) if l == u]
        qidxs += members[:-1]
        pidxs += members[1:]
    wpkl = tmp_path / "synth-whiten.pkl"
    with open(wpkl, "wb") as f:
        pickle.dump({"images": db_paths, "qidxs": qidxs, "pidxs": pidxs}, f)
    want = jtrain.make_retrieval_eval(datasets, image_size=64, batch_size=4,
                                      whiten_db=jtrain.whiten_db_from_pickle(str(wpkl)))(jmodel)
    got = ttrain.make_retrieval_eval(datasets, image_size=64, batch_size=4,
                                     whiten_db=ttrain.whiten_db_from_pickle(str(wpkl)))(
        _port_model(variables, jmodel.meta))
    assert set(got) == set(want) == {f"synth{t}/map{x}" for t in ("", "+whiten")
                                     for x in "EMH"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


def test_eval_hook_fires_every_test_freq(setup):
    root, db_paths, jmodel, variables = setup
    calls = []

    def eval_fn(m):
        calls.append(m)
        return {"synth/mapM": 1.0}

    tr = ttrain.Trainer(_port_model(variables, jmodel.meta), ttrain.tuples_from_folders(db_paths),
                        _cfg(ttrain, root, "hook", epochs=2, test_freq=2), eval_fn=eval_fn)
    hist = tr.fit(log=None)
    assert len(calls) == 1 and calls[0] is tr.model
    assert hist[0].eval_metrics == {} and hist[1].eval_metrics == {"synth/mapM": 1.0}
    assert any(rec.get("synth/mapM") == 1.0 for rec in tr.metrics.read())


def test_train_cli_with_eval_flags(setup, monkeypatch, tmp_path):
    """``cli.train`` wires its flags through to the trainer: the run
    directory is JAX's ``run_name``, ``metrics.jsonl`` carries the eval and
    ``+whiten`` rows, ``--resume`` picks up the checkpoint."""
    root, db_paths, jmodel, variables = setup
    monkeypatch.setattr(t_cli_train, "load_network",
                        lambda *a, **k: _port_model(variables, jmodel.meta))
    datasets, labels, uniq = _folder_eval(db_paths)
    wpkl = tmp_path / "synth-whiten.pkl"
    with open(wpkl, "wb") as f:
        pickle.dump({"images": db_paths, "qidxs": [0, 4, 8], "pidxs": [1, 5, 9]}, f)
    argv = [str(tmp_path / "runs"), "--training-dataset", str(root / "data" / "db"),
            "--arch", "resnet50", "--epochs", "1", "--image-size", "64", "--neg-num", "2",
            "--query-size", "8", "--pool-size", "12", "--lr", "1e-4", "--exp-decay", "0.0",
            "--update-every", "2", "--test-freq", "1", "--sos",
            "--test-datasets", str(root / "data" / "db"), "--test-whiten", str(wpkl),
            "--device", "cpu"]
    assert t_cli_train.main(argv) == 0
    args = t_cli_train.build_parser().parse_args(argv)
    assert t_cli_train.run_name(args) == j_cli_train.run_name(
        j_cli_train.build_parser().parse_args(argv[:-2]))
    run = tmp_path / "runs" / t_cli_train.run_name(args)
    rec = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert len(rec) == 1 and {"db/mapM", "db+whiten/mapM"} <= set(rec[0])
    assert t_cli_train._folder_eval_datasets([str(root / "data" / "db")])["db"]["qimages"] == \
        j_cli_train._folder_eval_datasets([str(root / "data" / "db")])["db"]["qimages"]
    assert t_cli_train.main(argv[:argv.index("--epochs") + 1] + ["2"]
                            + argv[argv.index("--epochs") + 2:] + ["--resume"]) == 0
    rec = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rec] == [0, 1]


def test_train_cli_needs_a_device_without_cuda(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, *_ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli_train.main([str(tmp_path), "--training-dataset", str(root / "data" / "db")])


# --- the closed loop --------------------------------------------------------

def test_closed_loop_training_improves_map(tmp_path):
    """The port's counterpart of the JAX closed-loop guard: mining, training
    and ``make_retrieval_eval`` on the same scene fixtures raise the
    held-out mapM by more than 0.05 from the port's random init."""
    root = str(tmp_path)
    pkl = tsynth.make_scene_sfm_dataset(root, n_scenes=8, views_per_scene=4, seed=0)
    eval_ds = tsynth.make_scene_revisited(root, n_scenes=6, db_views=5, seed=100)
    model = init_network({"architecture": "resnet50", "soa": True, "whitening": False},
                         seed=0, device="cpu")
    ds = ttrain.tuples_from_db_pickle(pkl, mode="train", nnum=3)
    eval_fn = ttrain.make_retrieval_eval({"scenes": eval_ds}, image_size=64, batch_size=8)
    cfg = ttrain.TrainConfig(
        epochs=2, lr=1e-4, exp_decay=0.1, image_size=64, nnum=3, batch_tuples=2,
        qsize=len(ds.qpool), poolsize=len(ds.images), freeze_backbone=False,
        checkpoint_dir=os.path.join(root, "run"), test_freq=1, seed=0,
    )
    trainer = ttrain.Trainer(model, ds, cfg, eval_fn=eval_fn)
    before = eval_fn(model)["scenes/mapM"]
    history = trainer.fit(log=None)
    after = next(m.eval_metrics for m in reversed(history) if m.eval_metrics)["scenes/mapM"]
    assert np.isfinite(before) and np.isfinite(after)
    assert after > before + 0.05, (before, after)


def test_profiling_utilities(tmp_path):
    """The port's ``metrics.jsonl`` records read back through JAX's logger."""
    from image_search_engine_for_historical_research_tpu.utils import profiling as jprof
    from image_search_engine_for_historical_research_tpu_torch.utils import profiling as tprof

    log = tprof.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log(0, loss=1.5, step_losses=[1.0, 2.0])
    log.log(1, loss=np.float32(0.5))
    got = jprof.MetricsLogger(log.path).read()
    assert [r["step"] for r in got] == [0, 1] and got[1]["loss"] == 0.5
    assert tprof.MetricsLogger(str(tmp_path / "none.jsonl")).read() == []
