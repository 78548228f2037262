"""PyTorch port vs JAX: the sharded feature store and ``cli.extract_1m``.

Shards carry the same file names and npz keys in both packages, so each reads
the other's; the resume point is JAX's; the port's ``extract_1m`` writes
JAX's rows in both resume modes (the ``_partial.npz`` checkpoint and the
shard prefix), with both loaders and in bf16; a chunk source over the shards
feeds the streaming PQ build, which equals the in-memory build.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_for_historical_research_tpu.cli import extract_1m as j_extract_1m
from image_search_engine_for_historical_research_tpu.data import load_path_features as j_load
from image_search_engine_for_historical_research_tpu.data import store as jstore
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m as t_extract_1m
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.data import store as tstore
from image_search_engine_for_historical_research_tpu_torch.index import build_pq
from image_search_engine_for_historical_research_tpu_torch.models import from_flax_variables
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    ONE_BLOCK,
    assert_same_arrays,
    clustered_rows,
    one_block_arch,
    one_torch_thread,
    perturbed_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_IMAGES = 7


# --- the sharded store ------------------------------------------------------

def _rows(n, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shards_read_across_packages(tmp_path, writer):
    """Shards one package writes, the other lists, resumes past and reads:
    the same file names, npz keys, rows and paths."""
    save = {"jax": jstore.save_feature_shard, "torch": tstore.save_feature_shard}[writer]
    x = _rows(10)
    names = [f"d/{i}.jpg" for i in range(10)]
    for s in (0, 4, 8):
        save("revisitop1m", s, x[s:s + 4], names[s:s + 4], root=str(tmp_path))
    files = sorted(os.listdir(tstore.shards_dir(str(tmp_path), "revisitop1m")))
    assert files == ["shard_000000000000_00000004.npz", "shard_000000000004_00000004.npz",
                     "shard_000000000008_00000002.npz"]
    assert set(np.load(os.path.join(tstore.shards_dir(str(tmp_path), "revisitop1m"),
                                    files[0])).files) == {"paths", "features"}
    for mod in (jstore, tstore):
        assert mod.shard_resume_point("revisitop1m", root=str(tmp_path)) == 10
        chunks_fn, n = mod.chunked_feature_source("revisitop1m", root=str(tmp_path))
        assert n == 10
        np.testing.assert_array_equal(np.concatenate(list(chunks_fn())), x)
        np.testing.assert_array_equal(np.concatenate(list(chunks_fn())), x)   # re-iterable
        assert mod.chunked_feature_relpaths("revisitop1m", root=str(tmp_path)) == names


def test_resume_point_with_holes_and_stale_shards(tmp_path):
    """A hole ends the prefix; a stale shard of an older grid is skipped with
    a warning, in both packages alike."""
    x = _rows(12, seed=1)
    names = [str(i) for i in range(12)]
    root = str(tmp_path)
    for s, c in ((0, 4), (4, 4), (2, 4), (10, 2)):           # (2, 4): stale; 8..10: a hole
        tstore.save_feature_shard("ds", s, x[s:s + c], names[s:s + c], root=root)
    for mod in (jstore, tstore):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert mod.shard_resume_point("ds", root=root) == 8
            assert [p[:2] for p in mod._list_shards("ds", root)] == [(0, 4), (4, 4)]
        assert any("stale" in str(w.message) for w in caught)
    assert tstore.shard_resume_point("missing", root=root) == 0
    with pytest.raises(FileNotFoundError):
        tstore.chunked_feature_source("missing", root=root)


def test_shard_write_is_checked_and_atomic(tmp_path):
    with pytest.raises(ValueError, match="2-D"):
        tstore.save_feature_shard("ds", 0, np.zeros(3), ["a"], root=str(tmp_path))
    with pytest.raises(ValueError, match="one path"):
        tstore.save_feature_shard("ds", 0, np.zeros((2, 3)), ["a"], root=str(tmp_path))
    p = tstore.save_feature_shard("ds", 0, np.ones((2, 3), np.float64), ["a", "b"],
                                  root=str(tmp_path))
    assert os.listdir(os.path.dirname(p)) == [os.path.basename(p)]   # no temporary left
    assert np.load(p)["features"].dtype == np.float32


def test_chunk_source_feeds_the_streaming_pq_build(tmp_path):
    """``chunked_feature_source`` goes to ``build_pq`` unchanged: the
    streamed build equals the in-memory build, array for array."""
    x = clustered_rows(n=1500, d=64, n_centers=24, seed=3)
    for s in range(0, 1500, 400):
        rows = x[s:s + 400]
        tstore.save_feature_shard("g", s, rows, [str(i) for i in range(s, s + len(rows))],
                                  root=str(tmp_path))
    chunks_fn, n = tstore.chunked_feature_source("g", root=str(tmp_path))
    kw = {"M": 8, "Ks": 32, "train_sample": 600, "iters": 4, "device": "cpu"}
    mem = build_pq(x, **kw)
    st = build_pq(chunks_fn, n=n, **kw)
    assert_same_arrays(mem.to_arrays()[1], st.to_arrays()[1], atol=0)


# --- cli.extract_1m ---------------------------------------------------------

@pytest.fixture(scope="module")
def revisitop(tmp_path_factory):
    """A revisitop1m layout (``revisitop1m.txt`` + ``jpg/``) of smooth JPEGs,
    some above the 64 px thumbnail side, and one carried one-block model."""
    root = tmp_path_factory.mktemp("revisitop")
    jpgdir = root / "revisitop1m" / "jpg"
    os.makedirs(jpgdir)
    rng = np.random.default_rng(0)
    names = []
    for i in range(N_IMAGES):
        h, w = (64, 80) if i % 2 else (96, 72)
        low = rng.uniform(0, 255, (4, 5, 3)).astype(np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))
        nm = f"d{i}.jpg"
        Image.fromarray(arr).save(jpgdir / nm, quality=92)
        names.append(nm)
    with open(root / "revisitop1m" / "revisitop1m.txt", "w") as f:
        f.write("\n".join(names))
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=6)
        jmodel.params = variables
        ckpt = root / "net.pth"
        torch.save({"state_dict": from_flax_variables(variables),
                    "meta": {"architecture": ONE_BLOCK}}, ckpt)
        tmodel = load_network(str(ckpt), ONE_BLOCK, device="cpu")
    return root, names, jmodel, tmodel


def _argv(root, out, *extra):
    return ["--data-root", str(root), "--outputs", str(out), "--image-size", "64",
            "--multiscale", "[1]", "--batch-size", "2", "--checkpoint-every", "4",
            "--arch", ONE_BLOCK] + list(extra)


@pytest.fixture(scope="module")
def jax_rows(revisitop, tmp_path_factory):
    """JAX's ``extract_1m`` rows, one store per loader."""
    root, _, jmodel, _ = revisitop
    out = {}
    with pytest.MonkeyPatch.context() as mp, one_block_arch():
        mp.setattr(j_extract_1m, "load_network", lambda *a, **k: jmodel)
        for loader in ("pil", "native"):
            d = tmp_path_factory.mktemp(f"jax_{loader}")
            assert j_extract_1m.main(_argv(root, d, "--loader", loader)) == 0
            out[loader] = j_load("revisitop1m", root=str(d))
    return out


@pytest.fixture
def port_model(revisitop, monkeypatch):
    tmodel = revisitop[3]
    tmodel.module.features.compute_dtype = None
    monkeypatch.setattr(t_extract_1m, "load_network", lambda *a, **k: tmodel)
    with one_block_arch():
        yield tmodel
    tmodel.module.features.compute_dtype = None


@pytest.mark.parametrize("loader", ["pil", "native"])
def test_extract_1m_checkpoint_resume_matches_jax(revisitop, jax_rows, port_model, tmp_path,
                                                  loader):
    """One store in the JAX layout; a ``_partial.npz`` checkpoint is resumed
    row for row (sentinel rows kept, the rest extracted) and removed."""
    root, names, _, _ = revisitop
    want, want_paths = jax_rows[loader]
    argv = _argv(root, tmp_path, "--loader", loader, "--device", "cpu")
    assert t_extract_1m.main(argv) == 0
    got, paths = j_load("revisitop1m", root=str(tmp_path))      # JAX reads the port's store
    assert paths == want_paths == names
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not os.path.exists(tmp_path / "revisitop1m_partial.npz")

    sentinel = np.full((N_IMAGES, got.shape[1]), 0.125, np.float32)
    np.savez(tmp_path / "revisitop1m_partial.npz", vecs=sentinel, done=4)
    assert t_extract_1m.main(argv) == 0
    got2, _ = j_load("revisitop1m", root=str(tmp_path))
    np.testing.assert_array_equal(got2[:4], sentinel[:4])
    np.testing.assert_allclose(got2[4:], want[4:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("loader", ["pil", "native"])
def test_extract_1m_shard_resume_matches_jax(revisitop, jax_rows, port_model, tmp_path, loader):
    """``--shard-size``: shards with JAX's rows; with ``--limit`` first, the
    second run resumes at ``shard_resume_point``; a dropped tail shard is
    re-extracted; JAX's chunk source reads the result."""
    root, names, _, _ = revisitop
    want, _ = jax_rows[loader]
    argv = _argv(root, tmp_path, "--loader", loader, "--device", "cpu", "--shard-size", "3")
    assert t_extract_1m.main(argv + ["--limit", "4"]) == 0
    assert tstore.shard_resume_point("revisitop1m", root=str(tmp_path)) == 4   # 0..3, 3..4
    assert t_extract_1m.main(argv) == 0
    starts = [s for s, _, _ in tstore._list_shards("revisitop1m", str(tmp_path))]
    assert starts == [0, 3, 4]
    chunks_fn, n = jstore.chunked_feature_source("revisitop1m", root=str(tmp_path))
    assert n == N_IMAGES
    np.testing.assert_allclose(np.concatenate(list(chunks_fn())), want, rtol=0, atol=1e-4)
    assert jstore.chunked_feature_relpaths("revisitop1m", root=str(tmp_path)) == names

    os.remove(tstore._list_shards("revisitop1m", str(tmp_path))[-1][2])
    assert tstore.shard_resume_point("revisitop1m", root=str(tmp_path)) == 4
    assert t_extract_1m.main(argv) == 0
    chunks_fn, n = tstore.chunked_feature_source("revisitop1m", root=str(tmp_path))
    np.testing.assert_allclose(np.concatenate(list(chunks_fn())), want, rtol=0, atol=1e-4)


def test_extract_1m_bf16(revisitop, jax_rows, port_model, tmp_path):
    """``--bf16`` runs the backbone in bfloat16: finite unit rows close to
    the f32 rows."""
    root, _, _, _ = revisitop
    want, _ = jax_rows["pil"]
    assert t_extract_1m.main(_argv(root, tmp_path, "--device", "cpu", "--bf16")) == 0
    assert port_model.module.features.compute_dtype == torch.bfloat16
    got, _ = j_load("revisitop1m", root=str(tmp_path))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)
    assert (np.sum(got * want, axis=1) > 0.99).all()


def test_extract_1m_needs_a_device_without_cuda(revisitop, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _, _, _ = revisitop
    with pytest.raises(RuntimeError, match="cuda"):
        t_extract_1m.main(_argv(root, tmp_path))


def test_extract_vectors_takes_an_extract_fn(revisitop, jax_rows):
    """``extract_vectors(extract_fn=)`` runs the caller's function (built
    once, as ``extract_1m`` and the trainer's mining build theirs) on every
    batch, with JAX's rows."""
    from image_search_engine_for_historical_research_tpu_torch.models.extract import (
        extract_vectors,
        make_extract_fn,
    )

    root, names, _, tmodel = revisitop
    paths = [str(root / "revisitop1m" / "jpg" / n) for n in names]
    inner = make_extract_fn(tmodel.module, scales=(1.0,))
    shapes = []

    def fn(images, mask):
        shapes.append(tuple(images.shape))
        return inner(images, mask)

    with one_block_arch():
        got = extract_vectors(tmodel, paths, 64, batch_size=2, extract_fn=fn)
    assert len(shapes) >= 4 and all(s[0] <= 2 for s in shapes)
    np.testing.assert_allclose(got, jax_rows["pil"][0], rtol=0, atol=1e-4)
