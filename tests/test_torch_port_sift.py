"""Device SIFT of the port (``ops.sift``) against the JAX package's on the
same seeded images: ``sift_program`` on textures and Gaussian blobs at 3
seeds and 2-3 octaves (valid masks equal; ``xy`` and ``scale`` within 1e-3
px, ``angle`` within 1e-4 rad wrapped, ``desc`` within 1e-4), every stage
on the same inputs, ``default_budgets``, a flat image, equal scores at the
budget's edge, and ``sift_extract_batch``. A ``cuda`` case holds the card
against the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from image_search_engine_for_historical_research_tpu.ops import sift as jsift
from image_search_engine_for_historical_research_tpu_torch.ops import sift as tsift
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = (1, 2, 3)
HW = (160, 192)


def _texture(seed, hw=HW):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (hw[0] // 8, hw[1] // 8))
    img = ndimage.zoom(base, 8, order=3).astype(np.float32)
    return (img - img.min()) / np.ptp(img)


def _blobs(seed, hw=HW, n=6):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]].astype(np.float32)
    img = np.zeros(hw, np.float32)
    for cy, cx, s in zip(rng.uniform(24, hw[0] - 24, n), rng.uniform(24, hw[1] - 24, n),
                         rng.uniform(2.5, 9.0, n)):
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 0.01, hw).astype(np.float32)
    return np.clip(img, 0, 1)


@pytest.fixture(scope="module")
def images():
    return np.stack([_texture(s) for s in SEEDS] + [_blobs(s) for s in SEEDS])


@pytest.fixture(scope="module")
def programs(images):
    """Both packages' ``sift_program`` on all six images, at 2 and 3 octaves
    with a 256-keypoint budget."""
    out = {}
    for n_oct in (2, 3):
        budgets = jsift.default_budgets(256, n_oct)
        j = jsift.sift_program(jnp.asarray(images), n_oct, budgets)
        t = tsift.sift_program(torch.from_numpy(images), n_oct, budgets)
        out[n_oct] = ({k: np.asarray(v) for k, v in j.items()},
                      {k: v.numpy() for k, v in t.items()})
    return out


def _assert_fields(j, t, rows=slice(None)):
    np.testing.assert_array_equal(t["valid"][rows], j["valid"][rows])
    np.testing.assert_allclose(t["xy"][rows], j["xy"][rows], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t["scale"][rows], j["scale"][rows], rtol=0, atol=1e-3)
    da = (t["angle"][rows] - j["angle"][rows] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(da).max() <= 1e-4
    np.testing.assert_allclose(t["desc"][rows], j["desc"][rows], rtol=0, atol=1e-4)
    fin = np.isfinite(j["score"][rows])
    np.testing.assert_array_equal(np.isfinite(t["score"][rows]), fin)
    np.testing.assert_allclose(t["score"][rows][fin], j["score"][rows][fin], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_oct", [2, 3])
@pytest.mark.parametrize("kind", ["texture", "blobs"])
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_sift_program_matches_jax(programs, n_oct, kind, i):
    j, t = programs[n_oct]
    b = i + (len(SEEDS) if kind == "blobs" else 0)
    assert j["valid"][b].sum() > 0
    _assert_fields(j, t, rows=b)


def test_stages_match_jax(images):
    """Blur, the octave, the DoG scores and offsets, patches, orientation
    and descriptors on the same inputs."""
    x = images[:2]
    k = jsift._gauss_kernel1d(1.3)
    np.testing.assert_array_equal(tsift._gauss_kernel1d(1.3), k)
    np.testing.assert_allclose(tsift._blur(torch.from_numpy(x), k).numpy(),
                               np.asarray(jax.jit(lambda a: jsift._blur(a, k))(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    gj = np.asarray(jax.jit(jsift.gaussian_octave)(jnp.asarray(x)))
    gt = tsift.gaussian_octave(torch.from_numpy(x))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-6)
    for dy, dx in ((1, 0), (-1, 1), (0, -1)):
        np.testing.assert_array_equal(tsift._shift2d(torch.from_numpy(x), dy, dx).numpy(),
                                      np.asarray(jsift._shift2d(jnp.asarray(x), dy, dx)))
    sj, oj = (np.asarray(a) for a in jax.jit(jsift.dog_keypoint_scores)(jnp.asarray(gj)))
    st, ot = tsift.dog_keypoint_scores(torch.from_numpy(gj))
    np.testing.assert_array_equal(np.isfinite(st.numpy()), np.isfinite(sj))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st.numpy()[fin], sj[fin], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ot.numpy()[fin], oj[fin], rtol=0, atol=1e-4)

    rng = np.random.default_rng(0)
    K = 12
    lvl = rng.integers(0, 5, (2, K))
    yc = rng.integers(-5, x.shape[1] + 5, (2, K))        # some past the edges: clamped
    xc = rng.integers(-5, x.shape[2] + 5, (2, K))
    pad = np.pad(gj, ((0, 0), (0, 0), (36, 36), (36, 36)), mode="edge")
    pt = tsift._extract_patches(torch.from_numpy(pad), *(torch.from_numpy(a)
                                                          for a in (lvl, yc, xc))).numpy()
    for b in range(2):
        pj = np.asarray(jsift._extract_patches(jnp.asarray(pad[b]), jnp.asarray(lvl[b]),
                                               jnp.asarray(yc[b]), jnp.asarray(xc[b])))
        np.testing.assert_array_equal(pt[b], pj)
    patches = pt.reshape(-1, tsift.PATCH, tsift.PATCH)
    sig = rng.uniform(1.6, 5.0, len(patches)).astype(np.float32)
    oj_ = [np.asarray(a) for a in jax.jit(jsift._orientation)(jnp.asarray(patches),
                                                              jnp.asarray(sig))]
    ot_ = [a.numpy() for a in tsift._orientation(torch.from_numpy(patches), torch.from_numpy(sig))]
    np.testing.assert_allclose(ot_[0], oj_[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ot_[2], oj_[2])
    ok = oj_[2]
    np.testing.assert_allclose(ot_[1][ok], oj_[1][ok], rtol=0, atol=1e-4)
    theta = rng.uniform(0, 2 * np.pi, len(patches)).astype(np.float32)
    np.testing.assert_allclose(
        tsift._descriptor(torch.from_numpy(patches), torch.from_numpy(theta),
                          torch.from_numpy(sig)).numpy(),
        np.asarray(jax.jit(jsift._descriptor)(jnp.asarray(patches), jnp.asarray(theta),
                                              jnp.asarray(sig))),
        rtol=0, atol=1e-5)


def test_default_budgets_match_jax():
    for max_kpts in (16, 64, 100, 256, 1000, 1024, 4096):
        for n_oct in range(1, 7):
            assert tsift.default_budgets(max_kpts, n_oct) == jsift.default_budgets(max_kpts, n_oct)


def test_flat_image_has_no_keypoints(images):
    img = np.full_like(images, 0.5)                    # the fixture's program, no new compile
    budgets = jsift.default_budgets(256, 2)
    t = tsift.sift_program(torch.from_numpy(img), 2, budgets)
    j = jsift.sift_program(jnp.asarray(img), 2, budgets)
    assert not t["valid"].any() and not np.asarray(j["valid"]).any()
    assert torch.equal(t["xy"], torch.zeros_like(t["xy"]))
    assert bool(torch.isinf(t["score"]).all())


def test_equal_scores_take_jax_s_slots():
    """Identical patterns on a grid give exactly equal DoG scores; with a
    budget below their number, the port keeps the keypoints JAX keeps (the
    lower flat index first), in JAX's order. Each pattern is a blob with a
    smaller one beside it, so its keypoints have one dominant orientation:
    an isotropic blob's orientation histogram is flat, and which bin wins
    there is decided by rounding."""
    yy, xx = np.mgrid[-16:17, -16:17].astype(np.float32)
    pattern = (np.exp(-(yy ** 2 + xx ** 2) / (2 * 3.0 ** 2))
               + 0.5 * np.exp(-((yy - 2) ** 2 + (xx - 4) ** 2) / (2 * 2.0 ** 2)))
    img = np.zeros((1, 128, 192), np.float32)
    for cy in (32, 96):                  # 64 px apart: no copy's blur reaches another's
        for cx in (32, 96, 160):
            img[0, cy - 16:cy + 17, cx - 16:cx + 17] = pattern
    for max_kpts in (8,):
        budgets = jsift.default_budgets(max_kpts, 2)
        j = {k: np.asarray(v) for k, v in jsift.sift_program(jnp.asarray(img), 2, budgets).items()}
        t = {k: v.numpy() for k, v in tsift.sift_program(torch.from_numpy(img), 2,
                                                         budgets).items()}
        s = j["score"][0][j["valid"][0]]
        assert len(s) and len(np.unique(s)) < len(s)       # the budget cuts through ties
        _assert_fields(j, t)
        np.testing.assert_array_equal(t["xy"], j["xy"])


def test_sift_extract_batch_matches_jax(images):
    fj = jsift.sift_extract_batch(images, max_kpts=256, n_octaves=3)   # the fixture's program
    ft = tsift.sift_extract_batch(images, max_kpts=256, n_octaves=3, device="cpu")
    for a, b in zip(fj, ft):
        assert a["count"] == b["count"] > 0
        n = a["count"]
        np.testing.assert_allclose(b["xy"][:n], a["xy"][:n], rtol=0, atol=1e-3)
        np.testing.assert_allclose(b["desc"], a["desc"], rtol=0, atol=1e-4)
        assert not b["desc"][n:].any()


def test_extraction_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsift.sift_extract_batch(np.zeros((1, 64, 64), np.float32))


@pytest.mark.cuda
def test_cuda_sift_matches_the_cpu(images):
    """The card's keypoints equal the CPU's plain path: valid masks, xy
    within 1e-2 px and descriptors within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    budgets = tsift.default_budgets(256, 3)
    c = {k: v.cpu().numpy() for k, v in tsift.sift_program(
        torch.as_tensor(images, device="cuda"), 3, budgets).items()}
    p = {k: v.numpy() for k, v in tsift.sift_program(torch.from_numpy(images), 3,
                                                     budgets).items()}
    np.testing.assert_array_equal(c["valid"], p["valid"])
    np.testing.assert_allclose(c["xy"], p["xy"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(c["desc"], p["desc"], rtol=0, atol=1e-3)
