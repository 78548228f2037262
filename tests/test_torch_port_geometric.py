"""The SIFT half of the port's ``rerank.geometric`` against the JAX
package's: ``make_verifier`` counts, ``LocalFeatures`` npz files read both
ways, ``sift_extract`` (OpenCV), ``sift_offline`` and ``sift_rerank`` with
the device backend (the port's SIFT on the CPU against JAX's
``backend="tpu"``) and with OpenCV, with and without a feature store,
``adalam_count_pairs`` in both dispatch modes, ``rerank_by_inliers`` on
ties, ``unnormalize`` / ``save_rank_montage``, and ``cli.test_reranking
--methods sift`` against the JAX CLI's mAP. Images are 192 x 144 px and
extraction keeps at most 128 keypoints. A ``cuda`` case holds the card's
re-rank against the CPU's."""

import functools
import inspect
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from image_search_engine_for_historical_research_tpu import data as jdata
from image_search_engine_for_historical_research_tpu import rerank as j_rerank
from image_search_engine_for_historical_research_tpu.rerank import geometric as jG
from image_search_engine_for_historical_research_tpu_torch import data as tdata
from image_search_engine_for_historical_research_tpu_torch import rerank as t_rerank
from image_search_engine_for_historical_research_tpu_torch.cli import test_reranking as t_cli
from image_search_engine_for_historical_research_tpu_torch.data import save_path_feature
from image_search_engine_for_historical_research_tpu_torch.rerank import geometric as tG
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RESIZE = (192, 144)
N_SCENES, VIEWS = 2, 2


def _cap_keypoints(monkeypatch):
    """Extraction in both packages keeps at most 128 keypoints."""
    def capped(fn):
        sig = inspect.signature(fn)

        def extract(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.arguments["max_kpts"] = 128
            return fn(*bound.args, **bound.kwargs)

        return extract

    for mod, name in ((jG, "sift_extract_tpu"), (tG, "sift_extract_device"),
                      (jG, "sift_extract"), (tG, "sift_extract")):
        monkeypatch.setattr(mod, name, capped(getattr(mod, name)))


@pytest.fixture(autouse=True)
def small_budgets(monkeypatch):
    _cap_keypoints(monkeypatch)


def _canvas(seed, hw=(220, 290)):
    rng = np.random.default_rng(seed)
    img = ndimage.zoom(rng.uniform(0, 255, (hw[0] // 10, hw[1] // 10)), 10, order=3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """``N_SCENES`` textures, each with a query and ``VIEWS`` other views,
    as a revisited ``roxford5k`` (gnd: a query's own views, the first easy,
    the rest hard). A view is a 200 x 150 crop resampled to 192 x 144: with
    whole-pixel shifts alone, matched keypoints land within 0.02 px of the
    transform, on AdaLAM's ``too_perfect`` threshold (a squared residual of
    1e-8), where the last bit of a product decides which side they fall."""
    root = tmp_path_factory.mktemp("geometric")
    jpg = root / "rdata" / "roxford5k" / "jpg"
    jpg.mkdir(parents=True)
    qpaths, dpaths, imlist, qimlist, gnd = [], [], [], [], []
    for c in range(N_SCENES):
        cv = _canvas(c)
        for v, (y, x) in enumerate([(0, 0), (12, 20), (30, 8)]):
            name = f"q{c}" if v == 0 else f"db{c}_{v}"
            p = str(jpg / f"{name}.jpg")
            Image.fromarray(cv[y:y + 150, x:x + 200]).resize(RESIZE, Image.BILINEAR).save(
                p, quality=92)
            (qpaths if v == 0 else dpaths).append(p)
            (qimlist if v == 0 else imlist).append(name)
        gnd.append({"easy": np.array([c * VIEWS]), "hard": np.arange(c * VIEWS + 1,
                                                                     (c + 1) * VIEWS),
                    "junk": np.array([], np.int64), "bbx": [0, 0, 192, 144]})
    with open(root / "rdata" / "roxford5k" / "gnd_roxford5k.pkl", "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    # global descriptors that rank the other scene's views first
    rng = np.random.default_rng(4)
    q = rng.standard_normal((N_SCENES, 16)).astype(np.float32)
    db = np.stack([q[(i // VIEWS + 1) % N_SCENES] * (0.9 if i % VIEWS else 1.2)
                   + 0.3 * rng.standard_normal(16) for i in range(len(dpaths))]).astype(np.float32)
    out = str(root / "rout")
    save_path_feature("roxford5k", db, imlist, root=out)
    save_path_feature("roxford5k_queries", q, qimlist, root=out)
    # a ranking whose top 3 hold one view of the other scene, then two own views
    ranks = np.array([[2, 0, 1, 3], [0, 2, 3, 1]])
    return root, qpaths, dpaths, ranks


@pytest.fixture(scope="module")
def jax_reranks(scenes):
    """JAX's ``sift_rerank`` of the top 3 with each backend."""
    _, qpaths, dpaths, ranks = scenes
    with pytest.MonkeyPatch.context() as mp:
        _cap_keypoints(mp)
        return {b: jG.sift_rerank(qpaths, dpaths, ranks, b=3, resize=RESIZE, pair_batch=8,
                                  backend="tpu" if b == "device" else "cv2")
                for b in ("device", "cv2")}


def _feats(mod, seed, n=120, K=128):
    rng = np.random.default_rng(seed)
    xy = np.zeros((K, 2), np.float32)
    xy[:n] = rng.uniform(20, 600, (n, 2))
    desc = np.zeros((K, 128), np.float32)
    d = rng.standard_normal((n, 128)).astype(np.float32)
    desc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
    angle = np.zeros((K,), np.float32)
    angle[:n] = rng.uniform(0, 6.28, n)
    scale = np.zeros((K,), np.float32)
    scale[:n] = rng.uniform(2, 6, n)
    return mod.LocalFeatures(xy=xy, scale=scale, angle=angle, desc=desc, count=n,
                             shape=(640, 640))


def _moved(mod, f, seed, angle=0.3, s=1.2, noise=0.0):
    """``f`` under a similarity transform (a true match of ``f``)."""
    rng = np.random.default_rng(seed)
    R = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]], np.float32)
    xy = f.xy.copy()
    n = f.count
    xy[:n] = s * f.xy[:n] @ R.T + [30.0, -12.0] + noise * rng.standard_normal((n, 2))
    ang = f.angle.copy()
    ang[:n] += angle
    sc = f.scale.copy()
    sc[:n] *= s
    d = f.desc.copy()
    d[:n] += 0.03 * rng.standard_normal((n, 128)).astype(np.float32)
    d[:n] /= np.linalg.norm(d[:n], axis=1, keepdims=True)
    return mod.LocalFeatures(xy=xy, scale=sc, angle=ang, desc=d, count=n, shape=f.shape)


def _as(mod, f):
    return mod.LocalFeatures(xy=f.xy, scale=f.scale, angle=f.angle, desc=f.desc,
                             count=f.count, shape=f.shape)


def test_verifier_counts_match_jax():
    f1 = _feats(tG, 0)
    pairs = [(f1, _moved(tG, f1, 1)), (f1, _moved(tG, f1, 2, noise=4.0)), (f1, _feats(tG, 3)),
             (f1, tG.LocalFeatures(f1.xy, f1.scale, f1.angle, f1.desc, 0, f1.shape))]
    tv, jv = tG.make_verifier(device="cpu"), jG.make_verifier()
    counts = [tv(a, b) for a, b in pairs]
    assert counts == [jv(_as(jG, a), _as(jG, b)) for a, b in pairs]
    assert counts[0] > 100 and counts[2] == 0 and counts[3] == 0
    # AdaLAM weighs residuals of exactly 0 as nothing: its true pair is noisy
    pairs = [(f1, _moved(tG, f1, 1, noise=1.0))] + pairs[2:]
    ta, ja = tG.make_adalam_verifier(device="cpu"), jG.make_adalam_verifier()
    counts = [ta(a, b) for a, b in pairs]
    assert counts == [ja(_as(jG, a), _as(jG, b)) for a, b in pairs]
    assert counts[0] > 50 and counts[2] == 0


def test_local_features_npz_both_ways(tmp_path):
    f = _feats(tG, 5)
    f.save(str(tmp_path / "t.npz"))
    g = jG.LocalFeatures.load(str(tmp_path / "t.npz"))
    _as(jG, f).save(str(tmp_path / "j.npz"))
    h = tG.LocalFeatures.load(str(tmp_path / "j.npz"))
    for x in (g, h):
        for k in ("xy", "scale", "angle", "desc"):
            np.testing.assert_array_equal(getattr(x, k), getattr(f, k))
        assert x.count == f.count and x.shape == f.shape


def test_sift_extract_and_offline_match_jax(scenes, tmp_path):
    _, qpaths, dpaths, _ = scenes
    a = tG.sift_extract(qpaths[0], RESIZE)
    b = jG.sift_extract(qpaths[0], RESIZE)
    assert a.count == b.count > 0 and a.shape == b.shape
    for k in ("xy", "scale", "angle", "desc"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    paths = qpaths + dpaths
    for backend, jbackend in (("cv2", "cv2"), ("device", "tpu")):
        st = tG.sift_offline(paths, str(tmp_path / f"t_{backend}"), RESIZE, backend=backend,
                             device="cpu")
        sj = jG.sift_offline(paths, str(tmp_path / f"j_{backend}"), RESIZE, backend=jbackend)
        assert [os.path.basename(p) for p in st] == [os.path.basename(p) for p in sj]
        for p, q in zip(st, sj):
            ft, fj = tG.LocalFeatures.load(p), jG.LocalFeatures.load(q)
            assert ft.count == fj.count and ft.shape == fj.shape
            np.testing.assert_allclose(ft.xy, fj.xy, rtol=0, atol=1e-3)
            np.testing.assert_allclose(ft.desc, fj.desc, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="unknown SIFT backend"):
        tG.sift_offline(paths, str(tmp_path / "x"), RESIZE, backend="gpu")


@pytest.mark.parametrize("backend, store", [("device", False), ("device", True),
                                            ("cv2", False), ("cv2", True)])
def test_sift_rerank_matches_jax(scenes, jax_reranks, tmp_path, backend, store):
    """Both packages promote each query's own views over the other scene's
    view the ranking put first, identically."""
    _, qpaths, dpaths, ranks = scenes
    kw = {"b": 3, "resize": RESIZE, "pair_batch": 8, "backend": backend, "device": "cpu"}
    t = tG.sift_rerank(qpaths, dpaths, ranks, store_dir=str(tmp_path) if store else None, **kw)
    np.testing.assert_array_equal(t, jax_reranks[backend])
    np.testing.assert_array_equal(t[:, 2], ranks[:, 0])
    if store:                                   # a second run reads the stored features
        assert len(os.listdir(tmp_path)) == 2 + 4
        np.testing.assert_array_equal(
            tG.sift_rerank(qpaths, dpaths, ranks, store_dir=str(tmp_path), **kw), t)


def test_sift_rerank_with_a_verifier_matches_jax(scenes):
    _, qpaths, dpaths, ranks = scenes
    t = tG.sift_rerank(qpaths, dpaths, ranks, b=4, resize=RESIZE, backend="cv2",
                       verifier=tG.make_verifier(device="cpu"), device="cpu")
    j = jG.sift_rerank(qpaths, dpaths, ranks, b=4, resize=RESIZE, verifier=jG.make_verifier())
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("dispatch", ["scan", "loop"])
def test_adalam_count_pairs_match_jax(dispatch):
    """Six features, so the bank has the shape of the re-rank tests' (one
    JAX program for all)."""
    f1, g1, h1 = (_feats(tG, s) for s in (10, 11, 14))
    f2, g2 = _moved(tG, f1, 12, noise=1.0), _moved(tG, g1, 13, angle=-0.5, noise=1.0)
    h2 = _feats(tG, 15)
    q = [f1, f1, g1, g1, h1]
    c = [f2, g2, g2, f2, h2]
    t = tG.adalam_count_pairs(q, c, dispatch=dispatch, device="cpu")
    jmap = {id(x): _as(jG, x) for x in (f1, f2, g1, g2, h1, h2)}
    j = jG.adalam_count_pairs([jmap[id(x)] for x in q], [jmap[id(x)] for x in c],
                              dispatch=dispatch)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int64 and t[0] > 50 and t[2] > 50
    loop = tG.adalam_count_pairs(q, c, pair_batch=2, dispatch="loop", device="cpu")
    np.testing.assert_array_equal(loop, t)
    assert len(tG.adalam_count_pairs([], [], device="cpu")) == 0


def test_rerank_by_inliers_is_stable_like_jax():
    rng = np.random.default_rng(0)
    ranks = np.stack([rng.permutation(20) for _ in range(5)])
    counts = rng.integers(0, 3, (5, 8))                 # many ties
    np.testing.assert_array_equal(tG.rerank_by_inliers(ranks, counts, 8),
                                  jG.rerank_by_inliers(ranks, counts, 8))


def test_unnormalize_and_rank_montage_match_jax(scenes, tmp_path):
    _, qpaths, dpaths, ranks = scenes
    x = np.random.default_rng(1).standard_normal((2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata.unnormalize(x), jdata.unnormalize(x))
    a = tdata.save_rank_montage(qpaths[0], dpaths, ranks[0], str(tmp_path / "t" / "m.jpg"),
                                k=4, thumb=48)
    b = jdata.save_rank_montage(qpaths[0], dpaths, ranks[0], str(tmp_path / "j" / "m.jpg"),
                                k=4, thumb=48)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_cli_sift_map_matches_jax(scenes, monkeypatch, capsys):
    """``--methods sift`` (the device backend under JAX's name ``tpu``, and
    a feature store) gives the JAX CLI's baseline and re-ranked mAP, and
    lifts it; ``loftr`` still exits at start-up. (JAX's CLI is imported here:
    it needs flax, which the card's machine lacks, and the file's ``cuda``
    case must collect there.)"""
    from image_search_engine_for_historical_research_tpu.cli import test_reranking as j_cli

    root, _, _, _ = scenes
    for mod in (j_rerank, t_rerank):                 # the images' own size, not 1000 x 1000
        monkeypatch.setattr(mod, "sift_rerank", functools.partial(mod.sift_rerank,
                                                                  resize=RESIZE))
    argv = ["--dataset", "roxford5k", "--data-root", str(root / "rdata"),
            "--outputs", str(root / "rout"), "--methods", "sift", "--sift-backend", "tpu"]
    out = t_cli.run(t_cli.build_parser().parse_args(
        argv + ["--sift-store", str(root / "t_store"), "--device", "cpu"]))
    seen = []
    fn = j_cli.compute_map_revisited
    monkeypatch.setattr(j_cli, "compute_map_revisited",
                        lambda *a, **k: seen.append(fn(*a, **k)) or seen[-1])
    assert j_cli.main(argv + ["--sift-store", str(root / "j_store")]) == 0
    assert list(out) == ["baseline", "sift"] and len(seen) == 2
    for res, ref in zip(out.values(), seen):
        for key in ("mapE", "mapM", "mapH"):
            assert getattr(res, key) == getattr(ref, key), key
    assert out["sift"].mapM > out["baseline"].mapM
    assert "after sift:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="LoFTR"):
        t_cli.main(argv[:4] + ["--methods", "sift,loftr", "--device", "cpu"])


def test_cv2_backend_without_opencv_fails_at_start_up(tmp_path, monkeypatch):
    """No OpenCV: ``--sift-backend cv2`` raises its import error before any
    data is read, and nothing falls back to the device SIFT."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = ["--dataset", "roxford5k", "--data-root", str(tmp_path / "missing"), "--methods",
            "qge,sift", "--sift-backend", "cv2", "--device", "cpu"]
    with pytest.raises(ImportError):
        t_cli.main(argv)
    with pytest.raises(ImportError):
        tG.sift_rerank(["q.jpg"], ["d.jpg"], np.zeros((1, 1), np.int64), backend="cv2",
                       device="cpu")


@pytest.mark.cuda
def test_cuda_sift_rerank_matches_the_cpu(scenes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, qpaths, dpaths, ranks = scenes
    kw = {"b": len(dpaths), "resize": RESIZE, "backend": "device"}
    np.testing.assert_array_equal(tG.sift_rerank(qpaths, dpaths, ranks, device="cuda", **kw),
                                  tG.sift_rerank(qpaths, dpaths, ranks, device="cpu", **kw))
