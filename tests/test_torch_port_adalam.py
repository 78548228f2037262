"""AdaLAM of the port (``rerank.adalam``) against the JAX package's on the
same seeded scenes (affine inliers, outliers, noisy descriptors, duplicated
keypoints): every helper, the keep-masks of ``filter_matches`` /
``match_and_filter`` (equal exactly), the batched, banked and banked-scan
counters against sequential ``match_and_filter`` and against JAX, the
configurations without refit and without the orientation / scale gates,
and a pair where no seed survives (the ratio-test fallback). A ``cuda``
case holds the card against the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu.rerank import adalam as ja
from image_search_engine_for_historical_research_tpu_torch.rerank import adalam as ta
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 192


def scene(seed=0, n_in=120, n_out=40, n_dup=0, imsize=800.0, theta=0.2):
    """One pair padded to K keypoints: ``n_in`` affine inliers (noise 1 px),
    ``n_out`` outliers, and ``n_dup`` inliers repeated exactly (equal
    residuals, the case ``_run_weights`` down-weights). Returns the keyword
    arrays of ``match_and_filter``."""
    rng = np.random.default_rng(seed)
    n = n_in + n_out
    k1 = rng.uniform(30, imsize - 30, (n, 2)).astype(np.float32)
    A = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]) * 1.1
    k2 = np.empty_like(k1)
    k2[:n_in] = k1[:n_in] @ A.T + [25.0, -12.0] + rng.normal(0, 1.0, (n_in, 2))
    k2[n_in:] = rng.uniform(30, imsize - 30, (n_out, 2))
    d = rng.standard_normal((n, 128)).astype(np.float32)
    d1 = d + 0.05 * rng.standard_normal((n, 128)).astype(np.float32)
    d2 = d + 0.05 * rng.standard_normal((n, 128)).astype(np.float32)
    o1 = rng.uniform(0, 360, n).astype(np.float32)
    o2 = (o1 + np.degrees(theta) + rng.normal(0, 3, n)).astype(np.float32)
    s1 = rng.uniform(2, 6, n).astype(np.float32)
    s2 = (s1 * 1.1).astype(np.float32)
    if n_dup:
        idx = rng.choice(n_in, n_dup, replace=False)
        arrs = [k1, k2, d1, d2, o1, o2, s1, s2]
        k1, k2, d1, d2, o1, o2, s1, s2 = (np.concatenate([a, a[idx]]) for a in arrs)
        n += n_dup

    def pad(a, fill=0.0):
        out = np.full((K,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    valid = np.arange(K) < n
    return dict(k1=pad(k1), k2=pad(k2), d1=pad(d1), d2=pad(d2), o1=pad(o1), o2=pad(o2),
                s1=pad(s1, 1.0), s2=pad(s2, 1.0), valid1=valid, valid2=valid,
                im1shape=(int(imsize), int(imsize)), im2shape=(int(imsize), int(imsize)))


def _shuffled(p, seed):
    q = dict(p)
    q["d2"] = np.random.default_rng(seed).permutation(p["d2"][:int(p["valid2"].sum())])
    q["d2"] = np.concatenate([q["d2"], p["d2"][len(q["d2"]):]])
    return q


SCENES = {
    "inliers": scene(0),
    "duplicates": scene(1, n_dup=30),
    "rotated": scene(2, theta=1.1),
    "no_consensus": _shuffled(scene(3), 9),
}


def _mf(filt, p):
    return filt.match_and_filter(p["k1"], p["k2"], p["d1"], p["d2"], im1shape=p["im1shape"],
                                 im2shape=p["im2shape"], o1=p["o1"], o2=p["o2"], s1=p["s1"],
                                 s2=p["s2"], valid1=p["valid1"], valid2=p["valid2"])


def test_helpers_match_jax():
    for iters in (1, 3, 10, 128, 130):
        np.testing.assert_array_equal(ta._first_k_couples(iters), ja._first_k_couples(iters))
    rng = np.random.default_rng(0)
    o1, o2 = (rng.uniform(-400, 400, 500).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        ta._orientation_diff(torch.from_numpy(o1), torch.from_numpy(o2)).numpy(),
        np.asarray(ja._orientation_diff(jnp.asarray(o1), jnp.asarray(o2))))

    # sorted residual rows with f16-equal runs (values one f32 ulp apart,
    # exact duplicates), zeros, and inf padding
    base = np.sort(rng.uniform(0, 0.02, (6, 40)).astype(np.float32), axis=1)
    base[:, 10:14] = base[:, 10:11]
    base[:, 20] = np.nextafter(base[:, 19], np.float32(1))
    base[1, :3] = 0.0
    base[2, 30:] = np.inf
    base[3] = np.inf
    rows = np.sort(base, axis=1)
    np.testing.assert_array_equal(ta._run_weights(torch.from_numpy(rows)).numpy(),
                                  np.asarray(ja._run_weights(jnp.asarray(rows))))
    for mc in (200.0, 50.0):
        got = ta._sorted_count(torch.from_numpy(rows), mc)
        want = ja._sorted_count(jnp.asarray(rows), mc)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)

    res = rng.uniform(0, 0.01, (3, 5, 64)).astype(np.float32)
    res[..., 5:9] = res[..., 4:5]
    member = rng.uniform(size=res.shape) < 0.7
    for mc in (200.0, 20.0):
        np.testing.assert_array_equal(
            ta._count_inliers(torch.from_numpy(res), torch.from_numpy(member), mc).numpy(),
            np.asarray(ja._count_inliers(jnp.asarray(res), jnp.asarray(member), mc)))
        got = ta._select_inliers(torch.from_numpy(res), torch.from_numpy(member), mc)
        want = ja._select_inliers(jnp.asarray(res), jnp.asarray(member), mc)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)

    px = rng.standard_normal((4, 7, 2, 2)).astype(np.float32)
    px[0, 0] = [[1.0, 2.0], [2.0, 4.0]]                      # singular: the det floor
    py = rng.standard_normal((4, 7, 2, 2)).astype(np.float32)
    A = ta._fit_affine(torch.from_numpy(px), torch.from_numpy(py)).numpy()
    np.testing.assert_allclose(A, np.asarray(ja._fit_affine(jnp.asarray(px), jnp.asarray(py))),
                               rtol=1e-5, atol=1e-5)
    for thr in (5.0, 1.5):
        np.testing.assert_array_equal(
            ta._ellipse_filter(torch.from_numpy(A), thr).numpy(),
            np.asarray(ja._ellipse_filter(jnp.asarray(A), thr)))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_match_and_filter_keeps_what_jax_keeps(name):
    p = SCENES[name]
    kj, mj = _mf(ja.AdalamFilter(), p)
    kt, mt = _mf(ta.AdalamFilter(device="cpu"), p)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(mt, mj)
    if name in ("inliers", "rotated"):
        assert kj.sum() > 100


def test_filter_matches_from_given_matches():
    """``filter_matches`` with the caller's matches and scores, no MNN mask
    and the image shapes left to the keypoints' spans."""
    p = SCENES["duplicates"]
    n = int(p["valid1"].sum())
    rng = np.random.default_rng(5)
    fnn = np.arange(K)
    fnn[n - 20:n] = rng.integers(0, n, 20)
    scores = rng.uniform(0.05, 0.9, K).astype(np.float32)
    args = (p["k1"], p["k2"], fnn, scores)
    kw = dict(o1=p["o1"], o2=p["o2"], s1=p["s1"], s2=p["s2"], valid1=p["valid1"])
    kj, _ = ja.AdalamFilter().filter_matches(*args, **kw)
    kt, _ = ta.AdalamFilter(device="cpu").filter_matches(*args, **kw)
    np.testing.assert_array_equal(kt, kj)
    with pytest.raises(ValueError, match="orientation gating"):
        ta.AdalamFilter(device="cpu").filter_matches(*args)
    with pytest.raises(ValueError, match="unknown AdaLAM config"):
        ta.AdalamFilter({"ransac": 3}, device="cpu")


@pytest.mark.parametrize("config", [
    {"refit": False},
    {"orientation_difference_threshold": None, "scale_rate_threshold": None},
    {"force_seed_mnn": False, "ransac_iters": 40, "max_seeds": 32, "max_neighbors": 48},
])
def test_other_configurations_match_jax(config):
    p = SCENES["duplicates"]
    kj, _ = _mf(ja.AdalamFilter(config), p)
    kt, _ = _mf(ta.AdalamFilter(config, device="cpu"), p)
    np.testing.assert_array_equal(kt, kj)
    assert kj.sum() > 100


def test_no_surviving_seed_falls_back_to_the_ratio_test():
    """Ten matches far apart: no neighbourhood reaches ``min_inliers``, so
    the filter keeps the ratio test's matches, as JAX does."""
    p = scene(4, n_in=10, n_out=0, imsize=4000.0)
    kj, _ = _mf(ja.AdalamFilter(), p)
    kt, _ = _mf(ta.AdalamFilter(device="cpu"), p)
    np.testing.assert_array_equal(kt, kj)
    assert 0 < kt.sum() <= 10


def _stack(pairs, key, dtype=torch.float32):
    return torch.as_tensor(np.stack([p[key] for p in pairs]), dtype=dtype)


def test_counters_equal_sequential_and_jax():
    """The batched counter (pairs stacked), the banked counter and the
    banked-scan counter (pairs gathered from a feature bank) give the
    surviving-match counts of sequential ``match_and_filter``, the port's
    and JAX's."""
    pairs = [SCENES[n] for n in sorted(SCENES)]
    filt = ta.AdalamFilter(device="cpu")
    seq = np.array([_mf(filt, p)[0].sum() for p in pairs])
    R = torch.tensor([filt.radius(p["im1shape"]) for p in pairs], dtype=torch.float32)
    args = [_stack(pairs, "k1"), _stack(pairs, "k2"), _stack(pairs, "d1"), _stack(pairs, "d2"),
            _stack(pairs, "o1"), _stack(pairs, "o2"), _stack(pairs, "s1"), _stack(pairs, "s2"),
            _stack(pairs, "valid1", torch.bool), _stack(pairs, "valid2", torch.bool), R, R]
    batched = filt.make_batched_counter()(*args).numpy()
    np.testing.assert_array_equal(batched, seq)

    # a bank of the pairs' two sides; pairs (i, i) and crossed ones
    xy = torch.cat([args[0], args[1]])
    desc = torch.cat([args[2], args[3]])
    odeg = torch.cat([args[4], args[5]])
    sc = torch.cat([args[6], args[7]])
    valid = torch.cat([args[8], args[9]])
    Rb = torch.cat([R, R])
    n = len(pairs)
    iq = torch.tensor([0, 1, 2, 3, 0, 2, 1, 3])
    ic = torch.tensor([n, n + 1, n + 2, n + 3, n + 2, n, n + 3, n + 1])
    banked = filt.make_banked_counter()(xy, desc, odeg, sc, valid, Rb, iq, ic).numpy()
    np.testing.assert_array_equal(banked[:n], seq)
    scan = filt.make_banked_scan_counter()(xy, desc, odeg, sc, valid, Rb, iq.reshape(4, 2),
                                           ic.reshape(4, 2)).numpy()
    np.testing.assert_array_equal(scan.reshape(-1), banked)
    jfilt = ja.AdalamFilter()              # JAX's per-pair filter on the banked pairs
    cross = [dict(pairs[int(q)], k2=pairs[int(c) - n]["k2"], d2=pairs[int(c) - n]["d2"],
                  o2=pairs[int(c) - n]["o2"], s2=pairs[int(c) - n]["s2"],
                  valid2=pairs[int(c) - n]["valid2"]) for q, c in zip(iq, ic)]
    np.testing.assert_array_equal(banked, [_mf(jfilt, p)[0].sum() for p in cross])


@pytest.mark.cuda
def test_cuda_counts_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in sorted(SCENES):
        kc, _ = _mf(ta.AdalamFilter(device="cuda"), SCENES[name])
        kp, _ = _mf(ta.AdalamFilter(device="cpu"), SCENES[name])
        np.testing.assert_array_equal(kc, kp)
