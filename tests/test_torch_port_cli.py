"""The offline, online (L2 and the PQ family), benchmark, test_reranking,
test_custom and retrieve CLIs of the port against the JAX package's: the
same JPEGs and checkpoint, the same feature stores and index artifacts read
by both packages, the same ids and the same mAP."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.cli import benchmark as j_benchmark
from image_search_engine_for_historical_research_tpu.cli import offline as j_offline
from image_search_engine_for_historical_research_tpu.cli import online as j_online
from image_search_engine_for_historical_research_tpu.cli import test_custom as j_test_custom
from image_search_engine_for_historical_research_tpu.cli import test_reranking as j_test_reranking
from image_search_engine_for_historical_research_tpu.data import (
    load_path_features as j_load_features,
)
from image_search_engine_for_historical_research_tpu.evaluation import (
    compute_map_revisited as j_compute_map_revisited,
)
from image_search_engine_for_historical_research_tpu.evaluation.ranks import (
    load_ranked_results as j_load_ranked,
)
from image_search_engine_for_historical_research_tpu.index import load_index as j_load_index
from image_search_engine_for_historical_research_tpu.index import matchers as j_matchers
from image_search_engine_for_historical_research_tpu.index.matchers import (
    matching_L2 as j_matching_L2,
)
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.rerank import (
    feature_enhancement as j_feature_enhancement,
)
from image_search_engine_for_historical_research_tpu_torch.cli import benchmark as t_benchmark
from image_search_engine_for_historical_research_tpu_torch.cli import offline as t_offline
from image_search_engine_for_historical_research_tpu_torch.cli import online as t_online
from image_search_engine_for_historical_research_tpu_torch.cli import retrieve as t_retrieve
from image_search_engine_for_historical_research_tpu_torch.cli import test_custom as t_test_custom
from image_search_engine_for_historical_research_tpu_torch.cli import (
    test_reranking as t_test_reranking,
)
from image_search_engine_for_historical_research_tpu_torch.data import (
    load_path_features,
    save_path_feature,
)
from image_search_engine_for_historical_research_tpu_torch.evaluation.ranks import (
    load_ranked_results as t_load_ranked,
)
from image_search_engine_for_historical_research_tpu_torch.index import HNSWIndex, load_index
from image_search_engine_for_historical_research_tpu_torch.models import from_flax_variables
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    ONE_BLOCK,
    assert_same_arrays,
    jax_forest_draws,
    one_block_arch,
    one_torch_thread,
    perturbed_variables,
    substitute_jax_fits,
    write_images,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 4


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    """Ten JPEGs under ``<data>/coll``, a one-block checkpoint, the JAX
    offline CLI's feature store (``jax_out``) and a synthetic store."""
    root = tmp_path_factory.mktemp("port_cli")
    data = root / "data"
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=5)
        ckpt = root / "net.pth"
        torch.save({"state_dict": from_flax_variables(variables),
                    "meta": {"architecture": ONE_BLOCK}}, ckpt)
        paths = write_images(data / "coll", 10, seed=1)
        common = ["--data-root", str(data), "--image-size", "96", "--network-path", str(ckpt),
                  "--arch", ONE_BLOCK, "--batch-size", "4"]
        assert j_offline.main(["--datasets", "coll", "--outputs", str(root / "jax_out"),
                               "--matching-method", "L2"] + common) == 0
        yield root, data, paths, common


def _offline(root, common, *extra):
    return t_offline.main(["--outputs", str(root / "out"), "--device", "cpu"] + common
                          + list(extra))


def test_offline_l2_extracts_the_jax_store(collection):
    root, data, paths, common = collection
    with one_block_arch():
        assert _offline(root, common, "--datasets", "coll", "--matching-method", "L2") == 0
    vt, pt = load_path_features("coll", root=str(root / "out"))
    vj, pj = j_load_features("coll", root=str(root / "out"))      # the JAX package reads it
    np.testing.assert_array_equal(vt, vj)
    assert pt == pj == [os.path.relpath(p, data) for p in paths]
    ref, ref_paths = j_load_features("coll", root=str(root / "jax_out"))
    assert ref_paths == pt
    np.testing.assert_allclose(vt, ref, rtol=0, atol=1e-4)


def test_offline_hnsw_from_stored_features(collection, capsys):
    """``--ifextracted`` over two stores, ``--ifgenerate`` writes the HNSW
    artifact, which the JAX package loads and searches; without
    ``--ifgenerate`` the artifact is reused."""
    root, data, _, common = collection
    out = root / "out"
    if not (out / "features" / "coll_path_feature.npz").exists():
        with one_block_arch():
            _offline(root, common, "--datasets", "coll", "--matching-method", "L2")
    rng = np.random.default_rng(2)
    synth = rng.standard_normal((150, 2048)).astype(np.float32)
    save_path_feature("synth", synth, [f"synth/{i}" for i in range(150)], root=str(out))
    args = ["--datasets", "coll,synth", "--ifextracted", "--matching-method", "HNSW"]
    assert _offline(root, common, *args, "--ifgenerate") == 0
    assert "probe query time" in capsys.readouterr().out
    art = out / "coll_synth" / "hnsw"
    tix = load_index(str(art), device="cpu")
    assert isinstance(tix, HNSWIndex) and tix.n == 160
    jix = j_load_index(str(art))
    np.testing.assert_array_equal(np.asarray(jix.nbr0), tix.nbr0.numpy())
    vecs = np.concatenate([load_path_features("coll", root=str(out))[0], synth])
    _, ids = jix.search(jnp.asarray(vecs[:5]), 3)
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], np.arange(5))
    mtime = os.path.getmtime(art / "arrays.npz")
    assert _offline(root, common, *args) == 0                  # loads, does not rebuild
    assert os.path.getmtime(art / "arrays.npz") == mtime


def test_online_l2_matches_jax_service(collection):
    root, data, paths, common = collection
    argv = ["--datasets", "coll", "--outputs", str(root / "jax_out"), "--matching-method", "L2",
            "--K", str(K)] + common
    with one_block_arch():
        jsvc = j_online.make_service(j_online.build_parser().parse_args(argv))
        tsvc = t_online.make_service(t_online.build_parser().parse_args(argv + ["--device", "cpu"]))
        try:
            assert type(tsvc.index).__name__ == "FlatIndex"
            for p in paths[:3]:
                jr, _ = jsvc.query_image(p)
                tr, _ = tsvc.query_image(p)
                assert [r["id"] for r in tr] == [r["id"] for r in jr], p
            assert [r["id"] for r in tsvc.query_image(paths[4])[0]][0] == 4
        finally:
            tsvc.close()


def _revisited(root, n=80, nq=6, d=32, seed=3):
    """A synthetic ``roxford5k``: clustered stored features and a gnd pickle
    whose easy / hard / junk sets are disjoint."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nq, d)).astype(np.float32)
    label = rng.integers(0, nq, n)
    db = centers[label] + 0.6 * rng.standard_normal((n, d)).astype(np.float32)
    q = centers + 0.3 * rng.standard_normal((nq, d)).astype(np.float32)
    gnd = []
    for i in range(nq):
        members = np.where(label == i)[0]
        sim = db[members] @ q[i]
        order = members[np.argsort(-sim)]
        third = max(1, len(order) // 3)
        gnd.append({"easy": order[:third], "hard": order[third:2 * third],
                    "junk": order[2 * third:], "bbx": [0, 0, 10, 10]})
    ddir = root / "rdata" / "roxford5k"
    ddir.mkdir(parents=True)
    with open(ddir / "gnd_roxford5k.pkl", "wb") as f:
        pickle.dump({"imlist": [f"db{i}" for i in range(n)],
                     "qimlist": [f"q{i}" for i in range(nq)], "gnd": gnd}, f)
    out = str(root / "rout")
    save_path_feature("roxford5k", db, [f"db{i}" for i in range(n)], root=out)
    save_path_feature("roxford5k_queries", q, [f"q{i}" for i in range(nq)], root=out)
    return db, q, gnd, ["--datasets", "roxford5k", "--data-root", str(root / "rdata"),
                        "--outputs", out, "--ifextracted", "--device", "cpu"]


def _assert_same_map(res, ref):
    for key in ("mapE", "mapM", "mapH"):
        assert getattr(res, key) == getattr(ref, key), key
    for key in ("mprE", "mprM", "mprH"):
        np.testing.assert_array_equal(getattr(res, key), getattr(ref, key))


def test_benchmark_map_matches_jax(tmp_path, monkeypatch):
    db, q, gnd, argv = _revisited(tmp_path)
    out = t_benchmark.run(t_benchmark.build_parser().parse_args(
        argv + ["--matching-method", "L2"]))["roxford5k"]
    ranks_j, _ = j_matching_L2(len(db), db, q)
    np.testing.assert_array_equal(out["ranks"], ranks_j)
    ref = j_compute_map_revisited(ranks_j, gnd, "roxford5k")
    _assert_same_map(out["map"], ref)
    assert 0.3 < ref.mapE <= 1.0 + 1e-9

    # alphaQE, as it runs on a gallery of at least QGE_BIG images
    monkeypatch.setattr(t_benchmark, "QGE_BIG", 10)
    out = t_benchmark.run(t_benchmark.build_parser().parse_args(
        argv + ["--matching-method", "L2", "--qge"]))["roxford5k"]
    _, ranks_qe = j_feature_enhancement(jnp.asarray(q), jnp.asarray(db),
                                        jnp.asarray(ranks_j), k=3, iterations=1)
    np.testing.assert_array_equal(out["ranks_qe"], np.asarray(ranks_qe))
    _assert_same_map(out["map_qe"], j_compute_map_revisited(np.asarray(ranks_qe), gnd,
                                                            "roxford5k"))


def _capture(monkeypatch, module, name):
    """Record every value ``module.<name>`` returns while the JAX CLI runs."""
    seen = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(fn(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, name, spy)
    return seen


def test_benchmark_qge_on_small_gallery_exits_before_extraction(tmp_path, monkeypatch):
    """``--qge`` on a gallery under ``QGE_BIG`` no longer exits: it runs
    alphaQE (k=10, three iterations) and then diffusion, and its ranks and
    ``map_dfs`` are the JAX benchmark CLI's."""
    db, q, gnd, argv = _revisited(tmp_path)
    out = t_benchmark.run(t_benchmark.build_parser().parse_args(
        argv + ["--matching-method", "L2", "--qge"]))["roxford5k"]
    jargv = [a for a in argv if a not in ("--device", "cpu")] + ["--qge"]
    seen = _capture(monkeypatch, j_benchmark, "compute_map_revisited")
    assert j_benchmark.main(jargv) == 0
    base, after_qe, after_dfs = seen
    _assert_same_map(out["map"], base)
    _assert_same_map(out["map_qe"], after_qe)
    _assert_same_map(out["map_dfs"], after_dfs)
    assert out["ranks_dfs"].shape == (len(q), len(db))
    _, ranks_qe = j_feature_enhancement(jnp.asarray(q), jnp.asarray(db),
                                        jnp.asarray(out["ranks"]), k=10, iterations=3)
    np.testing.assert_array_equal(out["ranks_qe"], np.asarray(ranks_qe))


def test_test_reranking_maps_match_jax(tmp_path, monkeypatch, capsys):
    """Every global method of ``cli.test_reranking`` gives the JAX CLI's
    revisited mAP on the same stored features."""
    _revisited(tmp_path)
    argv = ["--dataset", "roxford5k", "--data-root", str(tmp_path / "rdata"),
            "--outputs", str(tmp_path / "rout"), "--methods", "qge,aqe,dba,kr,diffusion"]
    out = t_test_reranking.run(t_test_reranking.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    seen = _capture(monkeypatch, j_test_reranking, "compute_map_revisited")
    assert j_test_reranking.main(argv) == 0
    names = ["baseline", "qge", "aqe", "dba", "kr", "diffusion"]
    assert list(out) == names and len(seen) == len(names)
    for name, ref in zip(names, seen):
        _assert_same_map(out[name], ref)
    assert "after kr:" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["test_custom", "retrieve"])
def test_custom_map_and_saved_ranks_match_jax(collection, tmp_path, monkeypatch, entry):
    """``cli.test_custom`` (and ``cli.retrieve --mode custom``) on label
    folders: JAX's folder-label mAP and the same saved ranking files."""
    root, data, paths, common = collection
    folders = tmp_path / "folders"
    for split, part in (("db", paths[:7]), ("q", paths[7:])):
        for i, src in enumerate(part):
            label = folders / split / f"label{i % 3}"
            label.mkdir(parents=True, exist_ok=True)
            (label / os.path.basename(src)).write_bytes(open(src, "rb").read())
    args = ["--db-dir", str(folders / "db"), "--query-dir", str(folders / "q"), "--K", "4",
            "--save-ranks", "--html-sheet"] + [a for a in common if a != "--data-root"
                                               and a != str(data)]
    seen = _capture(monkeypatch, j_test_custom, "map_custom")
    with one_block_arch():
        assert j_test_custom.main(args + ["--outputs", str(tmp_path / "jax")]) == 0
        targs = args + ["--outputs", str(tmp_path / "torch"), "--device", "cpu"]
        if entry == "retrieve":
            assert t_retrieve.main(["--mode", "custom"] + targs) == 0
        else:
            res = t_test_custom.run(t_test_custom.build_parser().parse_args(targs))
            assert res["map"] == seen[0] and res["saved"]["html"]
    ranks_t, qp_t, dp_t = t_load_ranked(str(tmp_path / "torch" / "ranks"))
    ranks_j, qp_j, dp_j = j_load_ranked(str(tmp_path / "jax" / "ranks"))
    np.testing.assert_array_equal(ranks_t, ranks_j)
    assert qp_t == qp_j and dp_t == dp_j
    for name in ("custom_ranking_result.json", "custom_ranking_result.html"):
        assert ((tmp_path / "torch" / "ranks" / name).read_text()
                == (tmp_path / "jax" / "ranks" / name).read_text())


def _spy_dispatch(monkeypatch, module, seen):
    """Record what ``module.dispatch_matcher`` returns."""
    fn = module.dispatch_matcher

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out[0])
        return out

    monkeypatch.setattr(module, "dispatch_matcher", spy)


@pytest.mark.parametrize("cli", ["offline", "benchmark"])
def test_unported_matching_method_exits_at_start(cli, tmp_path, monkeypatch):
    """``L2_int8`` through the port's ``cli.offline`` (stored features, its
    probe query's ids) and ``cli.benchmark`` (ranks and revisited mAP), held
    to the JAX CLI's and matcher's."""
    if cli == "offline":
        rng = np.random.default_rng(4)
        feats = rng.standard_normal((120, 64)).astype(np.float32)
        argv = ["--datasets", "coll", "--data-root", str(tmp_path), "--ifextracted",
                "--matching-method", "L2_int8", "--K", "9", "--loader", "pil"]
        seen_j, seen_t = [], []
        _spy_dispatch(monkeypatch, j_offline, seen_j)
        _spy_dispatch(monkeypatch, t_offline, seen_t)
        for side, main, extra in (("jax", j_offline.main, []),
                                  ("torch", t_offline.main, ["--device", "cpu"])):
            save_path_feature("coll", feats, [f"c/{i}" for i in range(120)],
                              root=str(tmp_path / side))
            assert main(argv + ["--outputs", str(tmp_path / side)] + extra) == 0
        assert seen_t[0].shape == (1, 9) and seen_t[0][0, 0] == 0
        np.testing.assert_array_equal(seen_t[0], seen_j[0])
        return
    db, q, gnd, argv = _revisited(tmp_path)
    out = t_benchmark.run(t_benchmark.build_parser().parse_args(
        argv + ["--matching-method", "L2_int8"]))["roxford5k"]
    ranks_j, _ = j_matchers.matching_L2_int8(len(db), db, q)
    np.testing.assert_array_equal(out["ranks"], ranks_j)
    _assert_same_map(out["map"], j_compute_map_revisited(ranks_j, gnd, "roxford5k"))


@pytest.mark.parametrize("method", ["ANNOY", "fractional", "LSH", "Greedyhash"])
def test_new_methods_through_offline_match_jax(tmp_path, monkeypatch, method):
    """Each of the remaining matchers through ``cli.offline --ifextracted
    --ifgenerate`` (the JAX CLI's matcher arguments), with JAX's random draws
    substituted at the port's seams: the probe query's ids equal JAX's, and
    the JAX package loads the forest the port wrote."""
    from image_search_engine_for_historical_research_tpu.ops import hashing as j_hashing
    from image_search_engine_for_historical_research_tpu_torch.index import rpforest as t_rp
    from image_search_engine_for_historical_research_tpu_torch.ops import hashing as t_hashing

    monkeypatch.setattr(t_rp, "_level_draws", jax_forest_draws)
    monkeypatch.setattr(t_hashing, "lsh_hyperplanes", lambda dim, n_bits, seed=42, device="cuda":
                        torch.from_numpy(np.array(j_hashing.lsh_hyperplanes(dim, n_bits, seed))))
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((6, 64))
    feats = (centers[rng.integers(0, 6, 150)] + 0.4 * rng.standard_normal((150, 64)))
    feats = feats.astype(np.float32)
    argv = ["--datasets", "coll", "--data-root", str(tmp_path), "--ifextracted", "--ifgenerate",
            "--matching-method", method, "--K", "12"]
    seen_j, seen_t = [], []
    _spy_dispatch(monkeypatch, j_offline, seen_j)
    _spy_dispatch(monkeypatch, t_offline, seen_t)
    for side, main, extra in (("jax", j_offline.main, []),
                              ("torch", t_offline.main, ["--device", "cpu"])):
        save_path_feature("coll", feats, [f"c/{i}" for i in range(150)], root=str(tmp_path / side))
        assert main(argv + ["--outputs", str(tmp_path / side)] + extra) == 0
    np.testing.assert_array_equal(seen_t[0], seen_j[0])
    if method == "ANNOY":
        # each package normalizes the rows itself (last bits differ), so the
        # planes' bf16 bits may differ at a rounding boundary
        got = j_load_index(str(tmp_path / "torch" / "coll" / "rpforest")).to_arrays()[1]
        want = j_load_index(str(tmp_path / "jax" / "coll" / "rpforest")).to_arrays()[1]
        assert_same_arrays(want, got, atol=1e-5, skip=("planes_bf16",))


@pytest.mark.parametrize("cli", ["offline", "online"])
@pytest.mark.parametrize("loader", ["pil", "native"])
def test_loader_flag(collection, tmp_path, cli, loader, monkeypatch):
    """``--loader pil`` and ``--loader native`` are taken as the JAX CLIs take
    them. The JPEGs are below the thumbnail side, so the native decoder's
    pixels are PIL's and both stores equal the JAX store; the native online
    service decodes its batches through the native loader."""
    from image_search_engine_for_historical_research_tpu_torch.serving import app as t_app

    root, data, paths, common = collection
    if cli == "offline":
        argv = ["--datasets", "coll", "--matching-method", "L2", "--outputs", str(tmp_path),
                "--device", "cpu", "--loader", loader] + common
        with one_block_arch():
            assert t_offline.main(argv) == 0
        ref, _ = j_load_features("coll", root=str(root / "jax_out"))
        np.testing.assert_allclose(load_path_features("coll", root=str(tmp_path))[0], ref,
                                   rtol=0, atol=1e-4)
        return
    argv = ["--datasets", "coll", "--outputs", str(root / "jax_out"), "--matching-method", "L2",
            "--K", str(K), "--device", "cpu", "--loader", loader] + common
    args = t_online.build_parser().parse_args(argv)
    calls = []
    decode = t_app.load_test_images_native
    monkeypatch.setattr(t_app, "load_test_images_native",
                        lambda *a, **k: calls.append(1) or decode(*a, **k))
    with one_block_arch():
        svc = t_online.make_service(args)
        try:
            assert svc.loader == loader
            assert [r["id"] for r in svc.query_image(paths[2])[0]][0] == 2
            assert [r["id"] for r in svc.query_batch(paths[3:5])[1][0]][0] == 4
        finally:
            svc.close()
    assert len(calls) == (loader == "native")


def _pq_stores(root, collection_root):
    """The JAX offline CLI's ``coll`` store and 250 clustered rows
    (``synth``), written under ``<root>/jax`` and ``<root>/torch``."""
    vecs, rel = j_load_features("coll", root=str(collection_root / "jax_out"))
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((12, 2048))
    synth = centers[rng.integers(0, 12, 250)] + 0.3 * rng.standard_normal((250, 2048))
    synth = (synth / np.linalg.norm(synth, axis=1, keepdims=True)).astype(np.float32)
    for side in ("jax", "torch"):
        save_path_feature("coll", vecs, rel, root=str(root / side))
        save_path_feature("synth", synth, [f"synth/{i}" for i in range(250)],
                          root=str(root / side))


@pytest.mark.parametrize("method, kind, extra", [
    ("HNSW_NanoPQ", "hnsw_pq", []),
    ("IVFPQ", "ivfpq", ["--refine-m", "8"]),
    ("PQ", "pq", ["--refine-m", "8"]),
])
def test_pq_family_offline_and_online_match_jax(collection, tmp_path, monkeypatch, method, kind,
                                                extra):
    """``cli.offline --ifextracted --ifgenerate`` builds the same artifact as
    the JAX CLI (JAX's fits substituted at the port's seams), and
    ``cli.online`` serves the JAX service's ids from it."""
    root, data, paths, common = collection
    substitute_jax_fits(monkeypatch)
    _pq_stores(tmp_path, root)
    argv = ["--datasets", "coll,synth", "--ifextracted", "--ifgenerate", "--matching-method",
            method] + extra + common
    assert j_offline.main(argv + ["--outputs", str(tmp_path / "jax")]) == 0
    assert t_offline.main(argv + ["--outputs", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    jarr = j_load_index(str(tmp_path / "jax" / "coll_synth" / kind)).to_arrays()[1]
    tix = load_index(str(tmp_path / "torch" / "coll_synth" / kind), device="cpu")
    tarr = tix.to_arrays()[1]
    # each package normalizes the rows itself (last bits differ), and the
    # residual level re-encodes 260 rows with 256 words a subspace, whose
    # nearly equal words decide a few boundary codes either way
    fuzzy = ("refine_codes", "node_codes", "node_norm2")
    assert_same_arrays(jarr, tarr, skip=fuzzy)
    for name in set(fuzzy[:2]) & set(jarr):
        assert np.mean(jarr[name] != tarr[name]) <= 0.01, name
    if "node_norm2" in jarr:
        same = (jarr["node_codes"] == tarr["node_codes"]).all(1)
        np.testing.assert_allclose(tarr["node_norm2"][same], jarr["node_norm2"][same], rtol=0,
                                   atol=1e-5)
    assert jarr.get("refine_codes", jarr.get("flat_refine")).shape[1] == (
        32 if kind == "hnsw_pq" else 8)

    sargv = ["--datasets", "coll,synth", "--matching-method", method, "--K", str(K)] + common
    with one_block_arch():
        jsvc = j_online.make_service(j_online.build_parser().parse_args(
            sargv + ["--outputs", str(tmp_path / "jax")]))
        tsvc = t_online.make_service(t_online.build_parser().parse_args(
            sargv + ["--outputs", str(tmp_path / "torch"), "--device", "cpu"]))
        try:
            assert type(tsvc.index).__name__ == type(jsvc.index).__name__
            for p in paths[:3]:
                assert ([r["id"] for r in tsvc.query_image(p)[0]]
                        == [r["id"] for r in jsvc.query_image(p)[0]]), p
            batch = tsvc.query_batch(paths[3:5])
            assert [[r["id"] for r in res] for res, _ in batch] == [
                [r["id"] for r in jsvc.query_image(p)[0]] for p in paths[3:5]]
        finally:
            tsvc.close()


def test_refine_m_reaches_hnsw_nanopq(collection, tmp_path):
    """The JAX ``cli.offline`` passes ``refine_M=`` to a matcher without that
    parameter and dies; the port builds the index with the flag's value."""
    root, data, _, common = collection
    _pq_stores(tmp_path, root)
    base = ["--datasets", "coll,synth", "--ifextracted", "--ifgenerate", "--matching-method",
            "HNSW_NanoPQ"] + common
    with pytest.raises(TypeError, match="refine_M"):
        j_offline.main(base + ["--refine-m", "16", "--outputs", str(tmp_path / "jax")])
    targv = base + ["--outputs", str(tmp_path / "torch"), "--device", "cpu"]
    art = str(tmp_path / "torch" / "coll_synth" / "hnsw_pq")
    for extra, width in ((["--refine-m", "16"], 16), ([], 32)):
        assert t_offline.main(targv + extra) == 0
        ix = load_index(art, device="cpu")
        assert ix.refine_codes.shape == (ix.n, width)


@pytest.mark.parametrize("method, flags", [
    ("PQ", ["--opq"]), ("Nano_PQ", ["--refine-m", "4"]), ("PQ_HNSW", ["--opq", "refine"]),
    ("HNSW_NanoPQ", ["--refine-m", "8"]), ("IVFPQ", ["--opq", "--refine-m", "4"]),
])
def test_pq_methods_through_benchmark_and_test_reranking(tmp_path, method, flags):
    """Each PQ-family method (with its flags) through ``cli.benchmark`` and
    ``cli.test_reranking`` on stored features: valid revisited mAP, the
    flags in the artifact, and the benchmark's ranks equal the matcher's."""
    from image_search_engine_for_historical_research_tpu_torch.index.matchers import MATCHERS

    db, q, gnd, argv = _revisited(tmp_path)
    out = t_benchmark.run(t_benchmark.build_parser().parse_args(
        argv + ["--matching-method", method, "--ifgenerate"] + flags))["roxford5k"]
    assert out["ranks"].shape == (len(q), len(db))
    for row in out["ranks"]:          # IVF leaves unprobed rows out (-1), as FAISS does
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid) and (method == "IVFPQ"
                                                           or len(valid) == len(db))
    for key in ("mapE", "mapM", "mapH"):
        assert 0.0 <= getattr(out["map"], key) <= 1.0 + 1e-9
    kind = {"PQ": "pq", "Nano_PQ": "pq", "IVFPQ": "ivfpq"}.get(method, "hnsw_pq")
    ix = load_index(str(tmp_path / "rout" / "roxford5k" / kind), device="cpu")
    arrays = ix.to_arrays()[1]
    if "--opq" in flags:
        assert "rotation" in arrays or "refine_rotation" in arrays
    if "--refine-m" in flags:
        m = int(flags[flags.index("--refine-m") + 1])
        assert arrays.get("refine_codes", arrays.get("flat_refine")).shape[1] == m
    ranks, _ = MATCHERS[method](len(db), db, q, "roxford5k", ifgenerate=False,
                                outputs=str(tmp_path / "rout"), device="cpu")
    np.testing.assert_array_equal(out["ranks"], ranks)
    res = t_test_reranking.run(t_test_reranking.build_parser().parse_args(
        ["--dataset", "roxford5k", "--data-root", str(tmp_path / "rdata"), "--outputs",
         str(tmp_path / "rout"), "--device", "cpu", "--methods", "aqe", "--matching-method",
         method] + flags))
    assert res["baseline"].mapE == out["map"].mapE and 0.0 <= res["aqe"].mapE <= 1.0 + 1e-9


@pytest.mark.parametrize("method", ["Nano_PQ", "HNSW_NanoPQ", "IVFPQ"])
def test_pq_methods_through_test_custom(collection, tmp_path, method):
    """``cli.test_custom`` with a PQ-family method: each query's own copy in
    the gallery at rank 0."""
    root, data, paths, common = collection
    folders = tmp_path / "folders"
    for split, part in (("db", paths), ("q", paths[:3])):
        for i, src in enumerate(part):
            label = folders / split / f"label{i % 3}"
            label.mkdir(parents=True, exist_ok=True)
            (label / os.path.basename(src)).write_bytes(open(src, "rb").read())
    args = ["--db-dir", str(folders / "db"), "--query-dir", str(folders / "q"), "--K", "4",
            "--matching-method", method, "--refine-m", "8", "--outputs", str(tmp_path / "out"),
            "--device", "cpu"] + [a for a in common if a not in ("--data-root", str(data))]
    with one_block_arch():
        res = t_test_custom.run(t_test_custom.build_parser().parse_args(args))
    assert res["ranks"].shape == (3, 4) and 0.0 < res["map"] <= 1.0
