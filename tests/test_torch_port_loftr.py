"""The port's LoFTR matcher (``models.loftr``) and ``loftr_rerank`` against
the JAX package's, with JAX's random-init variables carried across
(``from_flax_variables``): weights both ways and a released-layout file in
both packages, the backbone maps, the positional encoding, one encoder
layer, the confidence matrix and ``MatchResult`` at JAX's test config on
64 x 96 images (thr 0.0 and 0.2) and once at the default config at 480 x
640, the bf16 path against JAX's bf16 path, the three drivers' counts, and
``loftr_rerank`` with each driver. The
JAX modules are imported inside the tests, so the file's ``cuda`` cases
collect on a machine without Flax."""

import functools

import numpy as np
import pytest
import torch
from scipy import ndimage

from image_search_engine_for_historical_research_tpu_torch.models import loftr as T
from image_search_engine_for_historical_research_tpu_torch.rerank import geometric as tG
from torch_port_helpers import jax_bf16_dots, perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(initial_dim=32, block_dims=(32, 48, 64), d_coarse=64, d_fine=32, nhead=4,
             coarse_layers=("self", "cross") * 2, thr=0.0, max_matches=64)
HW = (64, 96)


def _jax():
    import jax

    from image_search_engine_for_historical_research_tpu.models import loftr as J

    return jax, J


def _texture(seed, hw=HW, shift=0):
    """A smooth grayscale texture (H, W, 1) in [0, 1], optionally rolled."""
    rng = np.random.default_rng(seed)
    img = ndimage.zoom(rng.uniform(0, 1, (hw[0] // 8 + 1, hw[1] // 8 + 1)), 8, order=3)
    img = np.clip(img[:hw[0], :hw[1]], 0, 1)
    return np.roll(img, shift, axis=1).astype(np.float32)[..., None]


def _pairs(n, hw=HW):
    """``n`` pairs: a texture against its shifted self and against another."""
    a = [_texture(s, hw) for s in range(n)]
    b = [_texture(s, hw, shift=4) if s % 2 == 0 else _texture(s + 100, hw) for s in range(n)]
    return np.stack(a), np.stack(b)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX's random-init variables (numpy) at ``SMALL`` (``init`` under
    ``jit``: the same values as ``init_matcher``, in a third of its time)."""
    import jax.numpy as jnp

    jax, J = _jax()
    dummy = jnp.zeros(HW + (1,), jnp.float32)
    jv = jax.jit(J.LoFTRMatcher(J.LoFTRConfig(**SMALL)).init)(jax.random.PRNGKey(0), dummy,
                                                              dummy)
    return jax.tree.map(np.asarray, jv)


def _models(jv, thr=0.0):
    """The JAX module at ``SMALL`` with ``thr``, and the port matcher that
    carries ``jv``."""
    _, J = _jax()
    tm = T.LoFTRMatcher(T.LoFTRConfig(**dict(SMALL, thr=thr)))
    tm.load_state_dict(T.from_flax_variables(jv, tm.config), strict=True)
    return J.LoFTRMatcher(J.LoFTRConfig(**dict(SMALL, thr=thr))), tm.eval().requires_grad_(False)


def _leaves(tree):
    jax, _ = _jax()
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def carried(jax_variables):
    jm, tm = _models(jax_variables)
    return jm, jax_variables, tm


def test_weights_both_ways_and_released_file(carried, tmp_path):
    """JAX variables -> port -> JAX's ``convert_loftr_state_dict`` gives
    them back exactly; a released-layout file (``matcher.`` prefix, BN
    ``num_batches_tracked``) loads in both packages."""
    _, J = _jax()
    _, jv, tm = carried
    cfg = J.LoFTRConfig(**SMALL)
    want = _leaves(jv)
    back = _leaves(J.convert_loftr_state_dict(tm.state_dict(), cfg))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
    sd = {"matcher." + k: v for k, v in tm.state_dict().items()}
    sd["matcher.backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "outdoor_ds.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    from_file = _leaves(J.load_loftr_checkpoint(str(path), cfg))
    assert all(np.array_equal(from_file[k], v) for k, v in want.items())
    loaded = T.load_loftr_checkpoint(str(path), tm.config, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert "matcher.loftr_coarse.layers.3.mlp.2.weight" in sd
    with pytest.raises(ValueError, match="shape"):
        T.from_flax_variables(jv, T.LoFTRConfig())      # the default widths


@pytest.mark.parametrize("d,temp_bug_fix", [(32, True), (32, False), (256, False)])
def test_positional_encoding_is_exact(d, temp_bug_fix):
    _, J = _jax()
    np.testing.assert_array_equal(T.sine_positional_encoding(7, 11, d, temp_bug_fix),
                                  J.sine_positional_encoding(7, 11, d, temp_bug_fix))


def test_backbone_maps_and_one_encoder_layer(carried):
    import jax.numpy as jnp

    _, J = _jax()
    _, jv, tm = carried
    x = np.stack([_texture(3), _texture(4)])
    jc, jf = J.ResNetFPN82(32, (32, 48, 64)).apply(
        {k: v["backbone"] for k, v in jv.items()}, jnp.asarray(x))
    with torch.no_grad():
        tc, tf = tm.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tc.permute(0, 2, 3, 1).numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(tf.permute(0, 2, 3, 1).numpy(), np.asarray(jf), atol=2e-5)

    rng = np.random.default_rng(0)
    f0, f1 = (rng.standard_normal((2, 40, 64)).astype(np.float32) for _ in range(2))
    layer = {"params": jv["params"]["loftr_coarse"]["layer1"]}
    want = J.LoFTREncoderLayer(64, 4).apply(layer, jnp.asarray(f0), jnp.asarray(f1))
    with torch.no_grad():
        got = tm.loftr_coarse.layers[1](torch.from_numpy(f0), torch.from_numpy(f1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_match(apply, jv, a, b):
    import jax.numpy as jnp

    res, inter = apply(jv, jnp.asarray(a), jnp.asarray(b))
    return res, np.asarray(inter["intermediates"]["conf_matrix"][0])


def _row(res):
    return T.MatchResult(*(x[0] for x in res))


def _assert_same_matches(jres, tres, tconf=None, jconf=None):
    conf = tres.conf.numpy()
    np.testing.assert_allclose(conf, np.asarray(jres.conf), rtol=1e-4, atol=1e-7)
    kept = conf > 0
    np.testing.assert_array_equal(kept, np.asarray(jres.conf) > 0)
    np.testing.assert_array_equal(tres.kpts0.numpy()[kept], np.asarray(jres.kpts0)[kept])
    np.testing.assert_allclose(tres.kpts1.numpy()[kept], np.asarray(jres.kpts1)[kept],
                               atol=1e-3)
    if tconf is not None:
        np.testing.assert_allclose(tconf, jconf, atol=1e-5)


@pytest.mark.parametrize("thr", [0.0, 0.2])
def test_match_result_matches_jax(jax_variables, thr):
    """JAX's test config on 64 x 96 images: the confidence matrix within
    1e-5, the kept rows and ``kpts0`` equal, ``kpts1`` within 1e-3 px, the
    counts equal, for a shifted copy and for another texture."""
    jax, _ = _jax()
    jv = jax_variables
    jm, tm = _models(jv, thr)
    apply = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))
    fn = T.make_match_fn(tm)
    a, b = _pairs(2)
    counts = []
    for i in range(2):
        jres, jconf = _jax_match(apply, jv, a[i], b[i])
        with torch.no_grad():
            tres, tconf = tm(torch.from_numpy(a[i:i + 1]), torch.from_numpy(b[i:i + 1]),
                             return_conf=True)
        _assert_same_matches(jres, fn(a[i], b[i]), tconf[0].numpy(), jconf)
        assert int(tres.num_matches[0]) == int(jres.num_matches)
        counts.append(int(jres.num_matches))
    if thr == 0.0:
        assert counts[0] > counts[1] > 0, counts


def test_default_config_pair_at_full_width():
    """The default config (d 256, 8 coarse layers, 196 / 256 blocks) on one
    480 x 640 pair, weights made by the port and read by JAX's converter:
    the confidence matrix within 1e-5 (every entry is below it here) and
    within 1e-3 of each row's maximum (1.8e-4 seen), and at ``thr=0.0`` the
    same matches."""
    import jax.numpy as jnp

    _, J = _jax()
    tm = T.init_matcher(device="cpu", thr=0.0)
    jm = J.LoFTRMatcher(J.LoFTRConfig(thr=0.0))
    jv = J.convert_loftr_state_dict(tm.state_dict(), jm.config)
    a, b = _texture(1, (480, 640)), _texture(1, (480, 640), shift=8)
    jax, _ = _jax()
    res, inter = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))(
        jv, jnp.asarray(a), jnp.asarray(b))
    jconf = np.asarray(inter["intermediates"]["conf_matrix"][0])
    with torch.no_grad():
        tres, tconf = tm(torch.from_numpy(a)[None], torch.from_numpy(b)[None], return_conf=True)
    tconf = tconf[0].numpy()
    np.testing.assert_allclose(tconf, jconf, atol=1e-5)
    gap = np.abs(tconf - jconf).max(1) / jconf.max(1)
    assert gap.max() <= 1e-3, gap.max()
    moved = np.nonzero(tconf.argmax(1) != jconf.argmax(1))[0]      # near-ties only
    assert len(moved) <= 2, moved
    tied = jconf[moved, tconf.argmax(1)[moved]] / jconf[moved].max(1)
    assert (tied >= 1 - 1e-3).all(), tied
    _assert_same_matches(res, _row(tres))
    assert int(tres.num_matches[0]) == int(res.num_matches) > 0


def test_drivers_give_the_same_counts_as_jax(carried):
    """Per-pair, batched and banked counts are equal, and equal JAX's
    batched counts; the banked driver pads nothing and reads back once."""
    import jax.numpy as jnp

    _, J = _jax()
    jm, jv, tm = carried
    a, b = _pairs(4)
    want = np.asarray(J.make_batched_count_fn(jm, jv)(jnp.asarray(a), jnp.asarray(b)))
    per_pair = [int(T.make_match_fn(tm)(a[i], b[i]).num_matches) for i in range(4)]
    batched = T.make_batched_count_fn(tm)(a, b)
    bank = np.concatenate([a, b])
    banked = T.make_banked_count_fn(tm)(bank, np.array([[0, 1], [2, 3]]),
                                        np.array([[4, 5], [6, 7]]))
    assert batched.dtype == torch.int64 and banked.shape == (2, 2)
    np.testing.assert_array_equal(per_pair, want)
    np.testing.assert_array_equal(batched.numpy(), want)
    np.testing.assert_array_equal(banked.reshape(-1).numpy(), want)


def test_bf16_drivers_run_and_keep_f32_weights(carried):
    _, _, tm = carried
    a, b = _pairs(2)
    counts = T.make_batched_count_fn(tm, compute_dtype=torch.bfloat16)(a, b)
    res = T.make_match_fn(tm, compute_dtype=torch.bfloat16)(a[0], b[0])
    assert counts.shape == (2,) and int(counts[0]) == int(res.num_matches) > 0
    assert res.conf.dtype == torch.float32 and torch.isfinite(res.kpts1).all()
    assert next(tm.parameters()).dtype == torch.float32


@pytest.fixture(scope="module")
def moved(jax_variables):
    """JAX's variables with every weight and BN statistic moved by seeded
    noise (random-init BN is the identity, in which no cast order shows),
    carried into the port."""
    jv = perturbed_variables(jax_variables)
    jm, tm = _models(jv)
    return jm, jv, tm


def _rel(got, want):
    """The largest gap over the largest magnitude of ``want``."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_backbone_and_encoder_layer_match_jax(moved):
    """bf16 against JAX's bf16 (its variables cast by ``_cast_floats``, BN
    statistics included), stage by stage on the same bf16 inputs: the
    backbone maps within 1e-2 of their largest value (4.6e-3 seen; 1.5e-2
    with the BN affine computed in f32 and then cast, the ResNet's order)
    and one encoder layer within 1e-2 (5.3e-3 seen; bf16's epsilon is
    3.9e-3)."""
    import jax.numpy as jnp

    jax, J = _jax()
    jm, jv, tm = moved
    jb = J._cast_floats(jv, jnp.bfloat16)
    x = np.stack([_texture(3), _texture(4)])
    jc, jf = jax.jit(J.ResNetFPN82(32, (32, 48, 64)).apply)(
        {k: v["backbone"] for k, v in jb.items()}, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        tc, tf = tm.backbone(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    gaps = [_rel(tc.permute(0, 2, 3, 1).float(), jc), _rel(tf.permute(0, 2, 3, 1).float(), jf)]

    rng = np.random.default_rng(0)
    f0, f1 = (rng.standard_normal((2, 40, 64)).astype(np.float32) for _ in range(2))
    with jax_bf16_dots():
        want = jax.jit(J.LoFTREncoderLayer(64, 4).apply)(
            {"params": jb["params"]["loftr_coarse"]["layer1"]},
            jnp.asarray(f0, jnp.bfloat16), jnp.asarray(f1, jnp.bfloat16))
    with torch.no_grad():
        got = tm.loftr_coarse.layers[1](torch.from_numpy(f0).bfloat16(),
                                        torch.from_numpy(f1).bfloat16())
    gaps.append(_rel(got.float(), want))
    assert got.dtype == torch.bfloat16 and max(gaps) <= 1e-2, gaps


def test_bf16_conf_matrix_and_counts_match_jax(moved):
    """The bf16 path end to end against JAX's ``compute_dtype=bfloat16`` on
    8 pairs at thr 0.0. bf16 rounding moves the confidence matrix far, in
    JAX as in the port (row maxima by up to a third), so the port's
    matrices are held to JAX's bf16 matrices no farther, in Frobenius norm
    summed over the pairs, than those lie from JAX's f32 matrices (0.72 of
    it seen; 1.17 with the BN affine computed in f32 and then cast, the
    ResNet's order). The counts of ``make_batched_count_fn`` each within 2
    of JAX's bf16 counts (gaps of 0-2 seen, 7 over the 8 pairs; the port's
    bf16 counts lie as far from its f32 counts, JAX's 2 from its own)."""
    import jax.numpy as jnp

    jax, J = _jax()
    jm, jv, tm = moved
    a, b = _pairs(8)
    port_gap = jax_gap = 0.0
    with jax_bf16_dots():
        apply = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))
        jb = J._cast_floats(jv, jnp.bfloat16)
        want = np.asarray(J.make_batched_count_fn(jm, jv, compute_dtype=jnp.bfloat16)(
            jnp.asarray(a), jnp.asarray(b)))
        for i in range(len(a)):
            _, jconf = _jax_match(apply, jb, a[i].astype(jnp.bfloat16), b[i].astype(jnp.bfloat16))
            _, j32 = _jax_match(apply, jv, a[i], b[i])
            with torch.no_grad():
                _, tconf = tm(*(torch.from_numpy(x[i:i + 1]).bfloat16() for x in (a, b)),
                              return_conf=True)
            assert tconf.dtype == torch.float32
            port_gap += np.linalg.norm(tconf[0].numpy() - jconf)
            jax_gap += np.linalg.norm(jconf - j32)
    got = T.make_batched_count_fn(tm, compute_dtype=torch.bfloat16)(a, b).numpy()
    assert port_gap <= jax_gap, (port_gap, jax_gap)
    assert (want > 0).all() and (np.abs(got - want) <= 2).all(), (got, want)


@pytest.fixture(scope="module")
def rerank_images(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("loftr_rerank")
    paths = {}
    for name, img in [("q0", _texture(10)), ("q1", _texture(11)),
                      ("d0", _texture(10, shift=6)), ("d1", _texture(12)),
                      ("d2", _texture(11, shift=5)), ("d3", _texture(13))]:
        paths[name] = str(d / f"{name}.jpg")
        cv2.imwrite(paths[name], (img[..., 0] * 255).astype(np.uint8))
    return paths


def test_loftr_rerank_matches_jax_with_each_driver(carried, rerank_images):
    """``loftr_rerank`` with ``match_fn`` / ``count_fn`` / ``banked_count_fn``
    against the JAX package's (its pair-batched counter; JAX's own tests hold
    its three drivers equal), 2 queries x 3 candidates at pair_batch 4 (the
    last block padded); the own views move to the top."""
    _, J = _jax()
    from image_search_engine_for_historical_research_tpu.rerank import geometric as jG

    jm, jv, tm = carried
    p = rerank_images
    qpaths, dpaths = [p["q0"], p["q1"]], [p["d0"], p["d1"], p["d2"], p["d3"]]
    ranks = np.array([[1, 3, 0, 2], [3, 0, 2, 1]])
    kw = dict(b=3, resolution=(96, 64), pair_batch=4)
    want = jG.loftr_rerank(qpaths, dpaths, ranks, count_fn=J.make_batched_count_fn(jm, jv), **kw)
    assert want[0, 0] == 0 and want[1, 0] == 2
    for driver, fn in (("match_fn", T.make_match_fn(tm)),
                       ("count_fn", T.make_batched_count_fn(tm)),
                       ("banked_count_fn", T.make_banked_count_fn(tm))):
        got = tG.loftr_rerank(qpaths, dpaths, ranks, **{driver: fn}, **kw)
        np.testing.assert_array_equal(got, want, err_msg=driver)
    with pytest.raises(ValueError, match="exactly one"):
        tG.loftr_rerank(qpaths, dpaths, ranks, match_fn=T.make_match_fn(tm),
                        count_fn=T.make_batched_count_fn(tm))
    np.testing.assert_array_equal(tG.loftr_rerank([], dpaths, ranks[:0], count_fn=None,
                                                  match_fn=T.make_match_fn(tm)), ranks[:0])


@pytest.mark.cuda
def test_cuda_counts_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a, b = _pairs(4, (96, 128))
    cpu = T.init_matcher(device="cpu", **SMALL)
    card = T.init_matcher(device="cuda", **SMALL)
    want = T.make_batched_count_fn(cpu)(a, b).numpy()
    np.testing.assert_array_equal(T.make_batched_count_fn(card)(a, b).cpu().numpy(), want)
    banked = T.make_banked_count_fn(card)(np.concatenate([a, b]), np.array([[0, 1, 2, 3]]),
                                          np.array([[4, 5, 6, 7]]))
    np.testing.assert_array_equal(banked.reshape(-1).cpu().numpy(), want)
