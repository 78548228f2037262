"""PyTorch port vs JAX: the native threaded JPEG loader and everything that
decodes through it.

The port builds its own copy of ``native/image_loader.cpp``; on the same files
its pixels equal the JAX package's, float and raw. ``extract_vectors(loader=
"native")`` and ``SearchService(loader="native").query_batch`` give JAX's
descriptors and ids. The link line names ``-ljpeg`` after the sources, so a
linker that drops libraries named before the objects needing them
(``--as-needed``) still resolves libjpeg's symbols.
"""

import ctypes
import os
import subprocess

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from image_search_engine_for_historical_research_tpu.cli import online as j_online
from image_search_engine_for_historical_research_tpu.data import images as jimages
from image_search_engine_for_historical_research_tpu.data import save_path_feature
from image_search_engine_for_historical_research_tpu.models import init_network as j_init
from image_search_engine_for_historical_research_tpu.models.extract import (
    extract_vectors as j_extract_vectors,
)
from image_search_engine_for_historical_research_tpu_torch import native
from image_search_engine_for_historical_research_tpu_torch.cli import online as t_online
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.data import images as timages
from image_search_engine_for_historical_research_tpu_torch.models import from_flax_variables
from image_search_engine_for_historical_research_tpu_torch.models.extract import (
    extract_vectors as t_extract_vectors,
)
from image_search_engine_for_historical_research_tpu_torch.serving import app as t_app
from torch_port_helpers import (  # noqa: F401  (one_torch_thread is a fixture)
    ONE_BLOCK,
    one_block_arch,
    one_torch_thread,
    perturbed_variables,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = [(480, 640), (1200, 900), (64, 64), (300, 200), (150, 260), (333, 97)]


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    """Smooth JPEGs of several sizes and aspects (some above, some below the
    thumbnail side) and one PNG, which the decoder rejects."""
    td = tmp_path_factory.mktemp("native_jpgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        a = ndimage.zoom(rng.uniform(0, 255, (max(h // 10, 2), max(w // 10, 2))), 10,
                         order=1)[:h, :w]
        arr = np.stack([a, np.roll(a, 5 + i, 0), np.roll(a, 9, 1)], -1)
        p = str(td / f"im{i}.jpg")
        Image.fromarray(arr.astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    png = str(td / "x.png")
    Image.fromarray(rng.uniform(0, 255, (120, 180, 3)).astype(np.uint8)).save(png)
    return paths, png


# --- the build --------------------------------------------------------------

def _loader_commands(out):
    compiler, rel, flags, link_flags = native._LIBRARIES["image_loader"]
    return native._commands(compiler, [os.path.join(native._PKG, s) for s in rel], out, flags,
                            link_flags)


def test_link_flags_follow_the_sources():
    for cmd in _loader_commands("out.so"):
        src = max(i for i, a in enumerate(cmd) if a.endswith("image_loader.cpp"))
        assert "-ljpeg" in cmd and cmd.index("-ljpeg") > src, cmd
        assert cmd.index("-o") < src


def test_library_links_with_as_needed(tmp_path):
    """Built with ``-Wl,--as-needed`` forced, the library still loads
    (``ctypes`` binds every symbol at load time) and decodes."""
    out = str(tmp_path / "libimage_loader.so")
    cmd = _loader_commands(out)[-1]
    cmd = [cmd[0], "-Wl,--as-needed"] + cmd[1:]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    assert lib.decode_thumbnail_batch


def test_load_builds_into_the_package_build_dir():
    lib = native.load("image_loader")
    assert os.path.exists(os.path.join(native.BUILD_DIR, "libimage_loader.so"))
    assert lib.decode_thumbnail_batch


# --- pixels -----------------------------------------------------------------

@pytest.mark.parametrize("imsize", [1024, 256, 96])
@pytest.mark.parametrize("raw", [False, True])
def test_pixels_equal_jax(jpgs, imsize, raw):
    paths, _ = jpgs
    want = jimages.load_test_images_native(paths, imsize, threads=3, raw=raw)
    got = timages.load_test_images_native(paths, imsize, threads=3, raw=raw)
    assert len(got) == len(paths)
    for p, a, b in zip(paths, got, want):
        assert a.dtype == b.dtype == (np.uint8 if raw else np.float32)
        assert a.shape == b.shape and max(a.shape[:2]) <= imsize, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_unresized_pixels_equal_pil(jpgs):
    """Where the thumbnail does not shrink, the decoder's pixels are PIL's."""
    paths, _ = jpgs
    got = timages.load_test_images_native([paths[2]], 256)[0]
    np.testing.assert_allclose(got, timages.load_test_image(paths[2], 256), atol=1e-6)
    raw = timages.load_test_images_native([paths[2]], 256, raw=True)[0]
    np.testing.assert_array_equal(raw, timages.load_test_image(paths[2], 256, raw=True))


def test_resized_pixels_near_pil(jpgs):
    """Shrunk images differ from PIL's at the filter level only (the bound
    of JAX's own test, at its size)."""
    paths, _ = jpgs
    for p, a in zip(paths, timages.load_test_images_native(paths, 1024, threads=2)):
        b = timages.load_test_image(p, 1024)
        assert a.shape == b.shape
        assert np.abs((a - b) * timages.IMAGENET_STD).mean() < 0.01, p


def test_non_jpeg_falls_back_to_pil(jpgs):
    paths, png = jpgs
    out = timages.load_test_images_native([paths[0], png], 512, threads=2)
    np.testing.assert_allclose(out[1], timages.load_test_image(png, 512), atol=1e-6)
    raw = timages.load_test_images_native([png], 512, raw=True)[0]
    np.testing.assert_array_equal(raw, jimages.load_test_images_native([png], 512, raw=True)[0])


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        timages.load_test_images_native([str(tmp_path / "nope.jpg")], 256)


def test_empty_batch_and_full_resolution(jpgs):
    paths, _ = jpgs
    assert timages.load_test_images_native([], 256) == []
    full = timages.load_test_images_native(paths[:2], None)
    for p, a in zip(paths, full):
        np.testing.assert_array_equal(a, timages.load_test_image(p, None))


# --- extraction and serving -------------------------------------------------

@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """A perturbed one-block ResNet101-SOLAR in both packages, and its
    checkpoint."""
    root = tmp_path_factory.mktemp("native_net")
    with one_block_arch():
        jmodel = j_init({"architecture": ONE_BLOCK})
        variables = perturbed_variables(jax.tree.map(np.asarray, jmodel.params), seed=9)
        jmodel.params = variables
        ckpt = root / "net.pth"
        torch.save({"state_dict": from_flax_variables(variables),
                    "meta": {"architecture": ONE_BLOCK}}, ckpt)
        tmodel = load_network(str(ckpt), ONE_BLOCK, device="cpu")
        yield jmodel, tmodel, ckpt


def test_extract_vectors_native_matches_jax(jpgs, net):
    paths, png = jpgs
    jmodel, tmodel, _ = net
    files = paths + [png]
    with one_block_arch():
        want = j_extract_vectors(jmodel, files, 96, scales=(1.0,), batch_size=2,
                                 loader="native")
        got = t_extract_vectors(tmodel, files, 96, scales=(1.0,), batch_size=2,
                                loader="native")
        pil = t_extract_vectors(tmodel, files, 96, scales=(1.0,), batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the decoders differ at the filter level only
    assert (np.sum(got * pil, axis=1) > 0.99).all()


def test_extract_vectors_rejects_unknown_loader(jpgs, net):
    paths, _ = jpgs
    _, tmodel, _ = net
    with pytest.raises(ValueError, match="loader"):
        t_extract_vectors(tmodel, paths, 96, loader="turbo")


def test_native_service_query_batch_matches_jax(jpgs, net, tmp_path, monkeypatch):
    """``--loader native`` in both packages' ``cli.online``: the batched
    path decodes through the native loader and returns JAX's ids."""
    paths, _ = jpgs
    jmodel, tmodel, ckpt = net
    outputs = tmp_path / "outputs"
    rng = np.random.default_rng(3)
    with one_block_arch():
        gal = t_extract_vectors(tmodel, paths, 160, batch_size=3)
    synth = rng.standard_normal((40, 2048)).astype(np.float32)
    synth /= np.linalg.norm(synth, axis=1, keepdims=True)
    save_path_feature("gal", np.concatenate([gal, synth]),
                      [f"g/{i}" for i in range(len(paths) + 40)], root=str(outputs))
    argv = ["--datasets", "gal", "--matching-method", "L2", "--outputs", str(outputs),
            "--image-size", "160", "--multiscale", "[1]", "--K", "5", "--network-path",
            str(ckpt), "--arch", ONE_BLOCK, "--loader", "native"]
    calls = []
    decode = t_app.load_test_images_native

    def spy(*a, **k):
        calls.append(len(a[0]))
        return decode(*a, **k)

    monkeypatch.setattr(t_app, "load_test_images_native", spy)
    with one_block_arch():
        jsvc = j_online.make_service(j_online.build_parser().parse_args(argv))
        tsvc = t_online.make_service(t_online.build_parser().parse_args(
            argv + ["--device", "cpu"]))
        assert tsvc.loader == "native"
        want = jsvc.query_batch(paths[:3])
        got = tsvc.query_batch(paths[:3])
    tsvc.close()
    assert calls == [3]
    for (rw, _), (rg, tg) in zip(want, got):
        assert [r["id"] for r in rg] == [r["id"] for r in rw]
        assert tg["batch"] == 3
    assert [r[0][0]["id"] for r in got] == [0, 1, 2]
    with pytest.raises(ValueError, match="loader"):
        type(tsvc)(tsvc.model, tsvc.index, tsvc.vecs, tsvc.paths, loader="turbo",
                   device="cpu")


@pytest.mark.parametrize("cli", ["offline", "online", "extract_1m"])
def test_native_loader_fails_at_start_up_without_libjpeg(monkeypatch, tmp_path, cli):
    """Where the library cannot be built (a machine without ``jpeglib.h``),
    ``--loader native`` fails at start-up with the build's message, before
    any image or network is loaded; ``--loader pil`` never builds it."""
    from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m as t_x1m
    from image_search_engine_for_historical_research_tpu_torch.cli import offline as t_offline

    def no_header(name):
        raise RuntimeError(f"building lib{name}.so failed:\nfatal error: jpeglib.h: "
                           "No such file or directory")

    monkeypatch.setattr(native, "load", no_header)
    loaded = []
    for mod in (t_offline, t_online, t_x1m):
        monkeypatch.setattr(mod, "load_network", lambda *a, **k: loaded.append(1))
    common = ["--device", "cpu", "--outputs", str(tmp_path), "--loader", "native"]
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        if cli == "offline":
            t_offline.main(["--datasets", "x", "--data-root", str(tmp_path)] + common)
        elif cli == "online":
            t_online.make_service(t_online.build_parser().parse_args(["--datasets", "x"]
                                                                     + common))
        else:
            t_x1m.main(["--data-root", str(tmp_path)] + common)
    assert not loaded
