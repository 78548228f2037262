"""The port's D2-Net (``models.d2net``) against the JAX package's, with the
port's seeded weights read by JAX's ``convert_d2net_state_dict``: the dense
features, a released-layout file in both packages, ``hard_detection`` and
``handcrafted_localization``, both resizes (torch's ``align_corners=True``
bilinear and its legacy ``nearest``), the multiscale pyramid (including a
scale skipped for want of keypoints), ``extract_d2net_features`` into the
verifier, and the compact stand-in with JAX's variables carried across
(mirroring ``tests/test_d2net.py``, against the JAX package rather than the
reference). The JAX modules are imported inside the tests, so the file's
``cuda`` case collects on a machine without Flax."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy import ndimage

from image_search_engine_for_historical_research_tpu_torch.models import d2net as T
from image_search_engine_for_historical_research_tpu_torch.rerank import geometric as tG
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax():
    import jax

    from image_search_engine_for_historical_research_tpu.models import d2net as J

    return jax, J


def _blurred(seed, hw):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.uniform(0, 1, hw + (3,)), (2, 2, 0)).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    _, J = _jax()
    m = T.init_d2net(seed=0, device="cpu")
    return m, J.DenseFeatureExtraction(True), J.convert_d2net_state_dict(m.state_dict())


def test_dense_features_and_released_file(both, tmp_path):
    import jax.numpy as jnp

    _, J = _jax()
    m, jm, jv = both
    img = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(img)[None])[0].numpy()
    want = np.asarray(jm.apply(jv, jnp.asarray(img)[None])[0])
    assert got.shape == want.shape == (11, 15, 512)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    path = tmp_path / "d2_tf.pth"
    torch.save({"model": m.state_dict(), "epoch": 1}, path)
    _, jv2 = J.load_d2net_checkpoint(str(path))
    for k in jv["params"]:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(jv2["params"][k][leaf]),
                                          np.asarray(jv["params"][k][leaf]))
    loaded = T.load_d2net_checkpoint(str(path), device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in m.state_dict().items())
    assert "dense_feature_extraction.model.21.weight" in m.state_dict()
    assert len(T.D2Net(use_relu=False).dense_feature_extraction.model) == 22


def test_detection_and_localization_match_jax():
    import jax.numpy as jnp

    _, J = _jax()
    feats = np.random.default_rng(1).uniform(0, 1, (14, 18, 512)).astype(np.float32)
    det = T.hard_detection(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(det, np.asarray(J.hard_detection(jnp.asarray(feats))))
    assert det.sum() > 20
    got = T.handcrafted_localization(torch.from_numpy(feats)).numpy()
    want = np.asarray(J.handcrafted_localization(jnp.asarray(feats)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    # tiny determinants amplify rounding; the pyramid gates |step| < 0.5
    ok = np.isfinite(want) & (np.abs(want) < 10)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-3)


@pytest.mark.parametrize("size", [(7, 9), (20, 30), (31, 17)])
def test_resizes_are_the_jax_packages(size):
    _, J = _jax()
    x = np.random.default_rng(2).standard_normal((13, 11, 5)).astype(np.float32)
    np.testing.assert_array_equal(T._resize_bilinear_ac(torch.from_numpy(x), size).numpy(),
                                  J._resize_bilinear_ac(x, size))
    m = np.random.default_rng(3).uniform(size=(13, 11)) < 0.3
    got = T._resize_nearest(torch.from_numpy(m).float(), size).numpy()
    np.testing.assert_array_equal(got, J._resize_nearest(m.astype(np.float32), size))
    legacy = F.interpolate(torch.from_numpy(m).float()[None, None], size=size, mode="nearest")
    np.testing.assert_array_equal(got, legacy[0, 0].numpy())


@pytest.mark.parametrize("hw,scales,kept", [((96, 128), (0.5, 1.0, 2.0), {0.5, 1.0, 2.0}),
                                             ((48, 64), (0.2, 0.5, 1.0), {0.2})])
def test_pyramid_matches_jax(both, hw, scales, kept):
    """Keypoints (the same set, in the same order; 1e-3 px, the sub-pixel
    step divides by small Hessian determinants), scores and descriptors. At
    48 x 64 over (0.2, 0.5, 1) the scales 0.5 and 1 yield no valid
    keypoint, so they are skipped and the 0.2 map is the one carried."""
    _, J = _jax()
    m, jm, jv = both
    img = _blurred(2, hw)
    k, s, d = T.process_multiscale(img, m, scales)
    jk, js, jd = J.process_multiscale(img, jm, jv, scales)
    assert k.shape == jk.shape and len(k) >= (20 if len(kept) == 3 else 1), (k.shape, jk.shape)
    np.testing.assert_allclose(k, jk, atol=1e-3)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(d, jd, atol=1e-5)
    assert k.dtype == s.dtype == d.dtype == np.float32
    assert {round(float(x), 3) for x in 1 / k[:, 2]} == kept


def test_extract_flows_into_the_verifier_as_jax(both):
    _, J = _jax()
    from image_search_engine_for_historical_research_tpu.rerank import geometric as jG

    m, jm, jv = both
    a, b = _blurred(3, (96, 128)), _blurred(4, (96, 128))
    fa, fb = (T.extract_d2net_features(m, x, max_kpts=256) for x in (a, b))
    ja, jb = (J.extract_d2net_features(jm, jv, x, max_kpts=256) for x in (a, b))
    for f, j in ((fa, ja), (fb, jb)):
        assert f.count == j.count > 10 and f.shape == j.shape
        np.testing.assert_allclose(f.xy, j.xy, atol=1e-3)
        np.testing.assert_allclose(f.desc, j.desc, atol=1e-5)
        np.testing.assert_array_equal(f.scale, j.scale)
        np.testing.assert_allclose(np.linalg.norm(f.desc[:f.count], axis=1), 1.0, atol=1e-5)
    counts = [tG.make_verifier(inlier_px=5.0, device="cpu")(fa, f) for f in (fa, fb)]
    assert counts == [jG.make_verifier(inlier_px=5.0)(ja, j) for j in (ja, jb)]
    assert counts[0] > counts[1]


@pytest.fixture(scope="module")
def stand_in():
    """JAX's ``init_dense_net`` variables carried into the port's
    ``DenseFeatureNet`` (``Conv_i`` -> ``convs.i``)."""
    jax, J = _jax()
    jm, jv = J.init_dense_net(dim=64, rng=jax.random.PRNGKey(0))
    m = T.DenseFeatureNet(64)
    m.load_state_dict({
        f"convs.{i}.{leaf}": torch.tensor(np.asarray(
            jv["params"][f"Conv_{i}"][flax]).transpose(*((3, 2, 0, 1) if leaf == "weight"
                                                         else (0,))))
        for i in range(5) for leaf, flax in (("weight", "kernel"), ("bias", "bias"))})
    return jm, jv, m.eval()


def test_stand_in_matches_jax(stand_in):
    import jax.numpy as jnp

    _, J = _jax()
    jm, jv, m = stand_in
    img = np.random.default_rng(0).uniform(0, 1, (64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        feats = m(torch.from_numpy(img)[None])[0]
    jfeats = jm.apply(jv, jnp.asarray(img)[None])[0]
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-5)
    xy, s, d = T.detect_keypoints(torch.tensor(np.asarray(jfeats)), max_kpts=100)
    jxy, js, jd = J.detect_keypoints(jfeats, max_kpts=100)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
    assert (np.diff(s.numpy()) <= 0).all()
    f = T.extract_dense_features(m, img, max_kpts=128)
    j = J.extract_dense_features(jm, jv, jnp.asarray(img), max_kpts=128)
    assert f.count == j.count == 128 and f.shape == j.shape == (64, 96)
    np.testing.assert_array_equal(f.xy, j.xy)
    np.testing.assert_allclose(f.desc, j.desc, atol=1e-5)
    assert tG.make_verifier(inlier_px=5.0, device="cpu")(f, f) > 50


@pytest.mark.cuda
def test_cuda_pyramid_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    img = _blurred(5, (96, 128))
    want = T.process_multiscale(img, T.init_d2net(device="cpu"))
    got = T.process_multiscale(img, T.init_d2net(device="cuda"))
    assert got[0].shape == want[0].shape
    for a, b, tol in zip(got, want, (1e-3, 1e-5, 1e-4)):
        np.testing.assert_allclose(a, b, atol=tol)
