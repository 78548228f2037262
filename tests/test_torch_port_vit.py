"""The port's DINOv2 ViT with registers (``models/vit.py``) against the
benchmark's plain reference (``perfbench/reference/dinov2-vitl14-reg4-
r1m-flat.py``, which runs each upload alone over its valid tokens, with no
mask), on seeded weights at a small width; its state-dict layout at full
width; the ViT served end to end through ``make_wsgi_app``; and the
architecture names that ``init_network`` and ``load_network`` take.

Tolerances: the port and the reference compute the same f32 operations in
other orders (a padded, masked batch against a packed single upload; fused
attention against a head-at-a-time softmax), so unit descriptors of 64
entries differ by a float32 ulp or two (3e-8 on these weights); ``TOL``
allows over 300 times that. Attention computed in bf16 moves them by
2e-4, twenty times ``TOL`` (``test_bf16_attention_fails_the_tolerance``)."""

import io
import math

import numpy as np
import pytest
import torch

from image_search_engine_for_historical_research_tpu_torch.models import retrieval, vit
from image_search_engine_for_historical_research_tpu_torch.models.extract import (
    _resize_images,
    _resize_mask,
    multiscale_descriptor,
)
from perfbench.harness.core import load_part
from torch_port_helpers import one_torch_thread  # noqa: F401

REF = load_part("reference", "dinov2-vitl14-reg4-r1m-flat")
SMALL = dict(patch_size=14, embed_dim=64, depth=2, num_heads=4, mlp_dim=256,
             num_register_tokens=4, pos_grid=5)
CFG = {**SMALL, "ln_eps": 1e-6, "architecture": "dinov2_vitl14_reg",
       "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225], "image_size": 112,
       "scales": [1.0, 2 ** 0.5, 0.5 ** 0.5]}
SIDE = 112
TOL = 1e-5
SCALES = tuple(CFG["scales"])


@pytest.fixture(scope="module")
def small(one_torch_thread):  # noqa: F811
    """The small ViT with the benchmark's seeded weights, and its state dict."""
    sd = load_part("systems", "dinov2").state_dict(CFG, 2 ** 31 + 17, "cpu")
    m = vit.DinoV2Retrieval(**SMALL)
    m.load_state_dict(sd, strict=True)
    return m.eval(), sd


def padded_batch():
    """A portrait and a landscape upload on one square canvas, random junk
    in the padded region, with their masks and (h, w)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, SIDE, SIDE, 3, generator=g)
    hw = [(SIDE, 70), (61, SIDE)]
    mask = torch.zeros(2, SIDE, SIDE, dtype=torch.bool)
    for b, (h, w) in enumerate(hw):
        mask[b, :h, :w] = True
    return x, mask, hw


def _gap(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("scale", SCALES + ("all",))
def test_padded_batch_matches_the_reference_over_valid_tokens(small, scale):
    m, sd = small
    x, mask, _ = padded_batch()
    with torch.no_grad():
        if scale == "all":
            got = multiscale_descriptor(m, x, mask, SCALES)
            want = torch.stack([REF.descriptor_of(sd, x[b], mask[b], CFG) for b in range(2)])
        else:
            xs = x if scale == 1.0 else _resize_images(x, scale)
            ms = mask if scale == 1.0 else _resize_mask(mask, scale)
            got = m(xs, ms)
            want = torch.stack([REF.net(sd, xs[b], ms[b], CFG) for b in range(2)])
    assert got.shape == (2, 64)
    assert _gap(got, want) < TOL
    # the rows are different uploads, a thousand tolerances apart
    assert float((got[0] - got[1]).norm()) > 1000 * TOL


def test_the_padded_region_changes_nothing_at_scale_1(small):
    """Padded patches are never keys and padded pixels are zeroed, so the
    junk outside the mask does not reach a descriptor."""
    m, _ = small
    x, mask, _ = padded_batch()
    clean = x * mask[..., None]
    with torch.no_grad():
        assert _gap(m(x, mask), m(clean, mask)) == 0.0
        # a mask that lets padded keys through does change the descriptor
        assert _gap(m(x, mask), m(x, torch.ones_like(mask))) > 1e-3


def test_bf16_attention_fails_the_tolerance(small, monkeypatch):
    m, sd = small
    x, mask, _ = padded_batch()
    real = vit.attention_core

    def bf16_core(q, k, v, keep):
        return real(q.bfloat16(), k.bfloat16(), v.bfloat16(), keep).float()

    monkeypatch.setattr(vit, "attention_core", bf16_core)
    with torch.no_grad():
        got = m(x, mask)
    want = torch.stack([REF.net(sd, x[b], mask[b], CFG) for b in range(2)])
    assert _gap(got, want) > TOL


def published_layout():
    """The released ``dinov2_vitl14_reg4_pretrain.pth`` keys and shapes."""
    d, m = 1024, 4096
    out = {"cls_token": (1, 1, d), "register_tokens": (1, 4, d), "mask_token": (1, d),
           "pos_embed": (1, 1 + 37 * 37, d), "patch_embed.proj.weight": (d, 3, 14, 14),
           "patch_embed.proj.bias": (d,)}
    for i in range(24):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                    b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                    b + "ls1.gamma": (d,), b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                    b + "mlp.fc1.weight": (m, d), b + "mlp.fc1.bias": (m,),
                    b + "mlp.fc2.weight": (d, m), b + "mlp.fc2.bias": (d,),
                    b + "ls2.gamma": (d,)})
    out.update({"norm.weight": (d,), "norm.bias": (d,)})
    return out


def test_full_width_state_dict_is_the_published_layout():
    with torch.device("meta"):
        m = vit.DinoV2Retrieval(**vit.ARCHITECTURES["dinov2_vitl14_reg"])
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    want = published_layout()
    assert got == want
    assert sum(math.prod(s) for s in want.values()) == 304_372_736
    assert retrieval.OUTPUT_DIM["dinov2_vitl14_reg"] == 1024


@pytest.fixture
def small_architecture(monkeypatch):
    """``dinov2_vitl14_reg`` built at the small width (the full width is
    1.2 GB of random weights on the CPU)."""
    monkeypatch.setitem(vit.ARCHITECTURES, "dinov2_vitl14_reg", dict(SMALL))


def test_init_network_builds_the_vit_and_refuses_what_it_does_not_take(small_architecture):
    model = retrieval.init_network({"architecture": "dinov2_vitl14_reg"}, device="cpu")
    assert isinstance(model.module, vit.DinoV2Retrieval)
    assert model.meta["architecture"] == "dinov2_vitl14_reg" and model.meta["pooling"] == "cls"
    assert model.meta["mean"] == CFG["mean"] and model.meta["std"] == CFG["std"]
    v = model.module(torch.zeros(1, 28, 28, 3))
    assert v.shape == (1, 64) and abs(float(v.norm()) - 1.0) < 1e-5
    with pytest.raises(ValueError, match="takes no"):
        retrieval.init_network({"architecture": "dinov2_vitl14_reg", "pooling": "gem"},
                               device="cpu")
    with pytest.raises(ValueError, match="dinov2_vitl14_reg") as e:
        retrieval.init_network({"architecture": "vit_l14"}, device="cpu")
    assert "resnet101" in str(e.value) and "vit_l14" in str(e.value)
    assert retrieval.architectures() == ["resnet101", "resnet152", "resnet50",
                                         "dinov2_vitl14_reg"]


def test_load_network_loads_a_released_layout_checkpoint_strictly(small_architecture, small,
                                                                   tmp_path):
    from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network

    _, sd = small
    path = tmp_path / "dinov2_vitl14_reg4_pretrain.pth"
    torch.save(sd, path)                        # a bare state dict, as released
    model = load_network(str(path), "dinov2_vitl14_reg", device="cpu")
    got = model.module.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    bad = dict(sd)
    bad.pop("register_tokens")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="register_tokens"):
        load_network(str(path), "dinov2_vitl14_reg", device="cpu")
    with pytest.raises(ValueError, match="unsupported architecture"):
        load_network(None, "dinov2_vitl14", device="cpu")


def test_extract_1m_refuses_bf16_for_the_vit(small_architecture, tmp_path, monkeypatch):
    from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m

    monkeypatch.setattr(extract_1m, "configdataset",
                        lambda name, root: {"n": 0, "imlist": [], "im_fname": None})
    with pytest.raises(SystemExit, match="float32 only"):
        extract_1m.main(["--data-root", str(tmp_path), "--arch", "dinov2_vitl14_reg",
                         "--bf16", "--device", "cpu", "--outputs", str(tmp_path)])


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def test_the_vit_served_end_to_end_through_the_wsgi_app(small, tmp_path):
    """Two uploads of different aspect POSTed concurrently to ``make_wsgi_app``
    over ``CoalescingService`` over ``SearchService`` (exact ``FlatIndex``
    at width 64, qge1): each reply is the reference's top-K after qge1 of
    the reference's descriptor of the same JPEG."""
    import json
    import threading

    from image_search_engine_for_historical_research_tpu_torch.index.flat import build_flat
    from image_search_engine_for_historical_research_tpu_torch.serving.app import (
        SearchService,
        make_wsgi_app,
    )
    from image_search_engine_for_historical_research_tpu_torch.serving.batching import (
        CoalescingService,
    )

    m, sd = small
    model = load_part("systems", "dinov2").build_model(CFG, sd, "cpu")
    assert model.module.state_dict().keys() == sd.keys()
    g = torch.Generator().manual_seed(9)
    gallery = torch.randn(3000, 64, generator=g)
    gallery /= gallery.norm(dim=1, keepdim=True)
    index = build_flat(gallery, metric="cosine", storage_dtype="float32", device="cpu")
    service = SearchService(model, index, gallery.numpy(), [f"g/{i}.jpg" for i in range(3000)],
                            K=10, scales=SCALES, image_size=SIDE, rerank="qge1", device="cpu")
    front = CoalescingService(service, max_batch=4, max_wait_ms=50.0)
    app = make_wsgi_app(front)
    rng = np.random.default_rng(3)
    jpegs = [_jpeg(rng.integers(0, 256, (112, 80, 3), np.uint8)),
             _jpeg(rng.integers(0, 256, (70, 112, 3), np.uint8))]
    replies = [None, None]

    def post(i):
        body = jpegs[i]
        environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/", "CONTENT_TYPE": "image/jpeg",
                   "CONTENT_LENGTH": str(len(body)), "HTTP_ACCEPT": "application/json",
                   "wsgi.input": io.BytesIO(body)}
        status = []
        out = b"".join(app(environ, lambda s, h: status.append(s)))
        replies[i] = (status[0], json.loads(out))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        front.close()
        service.close()
    unit = REF.normalize_rows(gallery.clone())
    for i, (status, payload) in enumerate(replies):
        assert status.startswith("200")
        canvas, hw = REF.decode_canvas(jpegs[i], SIDE)
        v = REF.descriptor(sd, canvas, hw, CFG, "cpu")[None]
        short = REF.top(v, unit, 10)[1]
        want = REF.top(REF.qge1_query(short, unit, 3, 4.0), unit, 10)[1][0].tolist()
        assert [r["id"] for r in payload["results"]] == want


def test_extract_1m_and_online_take_the_vit_by_arch(small_architecture, small, tmp_path,
                                                    monkeypatch):
    """``cli.extract_1m --arch dinov2_vitl14_reg`` stores a gallery of the
    ViT's 64-d descriptors (the small width here) and ``cli.online`` serves
    it with the same ``--arch`` and checkpoint; a gallery image POSTed
    back ranks itself first."""
    from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m, online
    from image_search_engine_for_historical_research_tpu_torch.data import load_path_features
    from image_search_engine_for_historical_research_tpu_torch.serving.app import make_wsgi_app
    from image_search_engine_for_historical_research_tpu_torch.serving.batching import (
        CoalescingService,
    )
    from torch_port_helpers import write_images

    _, sd = small
    ckpt = tmp_path / "dinov2_vitl14_reg4_pretrain.pth"
    torch.save(sd, ckpt)
    paths = write_images(tmp_path / "db", 6, seed=11)
    names = [p.split("/")[-1] for p in paths]
    monkeypatch.setattr(extract_1m, "configdataset", lambda name, root: {
        "n": len(paths), "imlist": names, "im_fname": lambda cfg, i: paths[i]})
    common = ["--arch", "dinov2_vitl14_reg", "--network-path", str(ckpt), "--image-size", "96",
              "--outputs", str(tmp_path / "out"), "--device", "cpu"]
    assert extract_1m.main(["--data-root", str(tmp_path), "--dataset", "db",
                            "--batch-size", "4"] + common) == 0
    vecs, stored = load_path_features("db", root=str(tmp_path / "out"))
    assert vecs.shape == (6, 64) and stored == names
    seen = {}
    monkeypatch.setattr(online, "serve", lambda svc, host, port, threaded=False:
                        seen.update(svc=svc))
    online.main(["--datasets", "db", "--matching-method", "L2", "--K", "3",
                 "--coalesce", "4"] + common)
    svc = seen["svc"]
    try:
        assert isinstance(svc, CoalescingService)
        assert isinstance(svc._svc.model.module, vit.DinoV2Retrieval)
        assert torch.equal(svc._svc.model.module.register_tokens, sd["register_tokens"])
        body = open(paths[3], "rb").read()
        environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/", "CONTENT_TYPE": "image/jpeg",
                   "CONTENT_LENGTH": str(len(body)), "HTTP_ACCEPT": "application/json",
                   "wsgi.input": io.BytesIO(body)}
        import json

        out = json.loads(b"".join(make_wsgi_app(svc)(environ, lambda s, h: None)))
        assert out["results"][0]["id"] == 3
    finally:
        svc.close()
        svc._svc.close()
