"""The port's tracing spans (``utils.tracing``): off they measure seconds and
record nothing; on (``enable()`` or a running ``torch.profiler``, seen
from any thread) they are stored with thread, parent and attributes, lie
on the profiler's clock and name a trace's idle gaps; the served path
records every stage it reports; tracing changes no result. The ``cuda``
case checks that a device span times the card without a synchronise."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_search_engine_for_historical_research_tpu_torch.utils import tracing
from perfbench.harness.trace import _ns, reduce_events
from torch_port_helpers import write_images


@pytest.fixture(autouse=True)
def clean_store():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def _by_name(name):
    return [r for r in tracing.spans() if r.name == name]


def test_off_a_span_times_the_block_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("created while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    assert not tracing.is_on()
    with tracing.span("off.outer", device="cuda", rows=3) as outer:
        with tracing.span("off.inner", device=torch.device("cuda", 0)):
            time.sleep(0.002)
    tracing.record("off.queue", 0, 10)
    assert outer.seconds >= 0.002
    assert tracing.spans() == []
    assert tracing.summary() == {"spans": {}, "dropped": 0}


def test_enabled_spans_store_thread_parent_attrs_and_self_time():
    tracing.enable()
    with tracing.span("a.outer", rows=4) as outer:
        time.sleep(0.002)
        with tracing.span("a.inner", request=7) as inner:
            time.sleep(0.003)
        with tracing.span("a.inner", request=8):
            pass
    tracing.record("a.queue", 1_000, 3_001_000, request=7)
    (o,) = _by_name("a.outer")
    i1, i2 = _by_name("a.inner")
    assert o.parent is None and i1.parent == o.id and i2.parent == o.id
    assert o.thread == threading.current_thread().name and o.attrs == {"rows": 4}
    assert (i1.attrs, i2.attrs) == ({"request": 7}, {"request": 8})
    assert o.seconds == outer.seconds and i1.seconds == inner.seconds
    assert o.start_ns <= i1.start_ns <= i1.end_ns <= i2.start_ns <= o.end_ns
    s = tracing.summary()
    assert s["dropped"] == 0
    assert s["spans"]["a.outer"]["count"] == 1 and s["spans"]["a.inner"]["count"] == 2
    assert s["spans"]["a.outer"]["self_s"] == pytest.approx(o.seconds - i1.seconds - i2.seconds)
    assert s["spans"]["a.inner"]["self_s"] == pytest.approx(i1.seconds + i2.seconds)
    assert s["spans"]["a.queue"] == {"count": 1, "host_s": pytest.approx(3e-3),
                                     "self_s": pytest.approx(3e-3), "device_s": None}
    assert all(v["device_s"] is None for v in s["spans"].values())


def test_the_store_is_capped_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("cap.x"):
            pass
    assert tracing.summary() == {"spans": {"cap.x": {"count": 3, "host_s": pytest.approx(
        sum(r.seconds for r in tracing.spans())), "self_s": pytest.approx(
        sum(r.seconds for r in tracing.spans())), "device_s": None}}, "dropped": 2}
    tracing.reset()
    assert tracing.summary() == {"spans": {}, "dropped": 0}


def test_a_running_profiler_turns_spans_on_in_a_worker_thread():
    def work():
        with tracing.span("w.outer"):
            with tracing.span("w.inner", rows=2):
                torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=work, name="span-worker")
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    (o,), (i,) = _by_name("w.outer"), _by_name("w.inner")
    assert o.thread == i.thread == "span-worker"
    assert i.parent == o.id and i.attrs == {"rows": 2}
    with tracing.span("w.after"):
        pass
    assert _by_name("w.after") == []


def test_a_span_lies_on_the_profilers_clock_and_names_an_idle_gap():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("clock.span"):
            time.sleep(0.005)
    (rec,) = _by_name("clock.span")
    host = [(ev.name(), _ns(ev, "start"), _ns(ev, "start") + _ns(ev, "duration"))
            for ev in prof.profiler.kineto_results.events()]
    (kin,) = [h for h in host if h[0] == "clock.span"]
    assert abs(kin[1] - rec.start_ns) < 1_000_000
    assert abs(kin[2] - rec.end_ns) < 1_000_000
    s, e = kin[1], kin[2]
    device = [("before", s - 1_000_000, s + 100_000), ("after", e - 100_000, e + 1_000_000)]
    out = reduce_events(device, host, (s - 1_000_000, e + 1_000_000))
    assert out["idle_gaps"][0][0] == "clock.span"
    assert out["idle_gaps"][0][1] == pytest.approx((e - s - 200_000) / 1e9)


@pytest.fixture(scope="module")
def solar(tmp_path_factory):
    from image_search_engine_for_historical_research_tpu_torch.index import build_flat
    from image_search_engine_for_historical_research_tpu_torch.models import init_network
    from image_search_engine_for_historical_research_tpu_torch.serving import SearchService

    paths = write_images(str(tmp_path_factory.mktemp("tracing_images")), 6, seed=11)
    model = init_network({"architecture": "resnet50"}, device="cpu")
    gallery = np.random.default_rng(3).standard_normal((40, 2048)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    svc = SearchService(model, build_flat(gallery, device="cpu"), gallery,
                        [f"g{i}.jpg" for i in range(40)], K=5, scales=(1.0, 2 ** 0.5, 0.5 ** 0.5),
                        image_size=64, device="cpu")
    yield svc, paths
    svc.close()


def test_the_coalesced_service_records_every_stage(solar):
    from image_search_engine_for_historical_research_tpu_torch.serving import CoalescingService

    svc, paths = solar
    tracing.enable()
    cs = CoalescingService(svc, max_batch=4, max_wait_ms=50.0)
    replies = [None] * len(paths)

    def ask(i):
        replies[i] = cs.query_image(paths[i])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(paths))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        cs.close()
    assert not any(t.is_alive() for t in threads) and all(r is not None for r in replies)
    queue = _by_name("serve.queue")
    assert sorted(r.attrs["request"] for r in queue) == list(range(len(paths)))
    assert all(r.end_ns >= r.start_ns for r in queue)
    batches = _by_name("serve.batch")
    assert sorted(i for b in batches for i in b.attrs["requests"]) == list(range(len(paths)))
    assert [b.attrs["rows"] for b in batches] == [len(b.attrs["requests"]) for b in batches]
    assert {b.thread for b in batches} == {"serving-device"}
    n = cs.batches_run
    for name in ("serve.decode", "serve.extract", "serve.search", "serve.rerank",
                 "serve.reply", "serve.coalesce"):
        assert len(_by_name(name)) == n, name
    for name in ("serve.extract", "serve.search", "serve.rerank"):
        assert {r.parent for r in _by_name(name)} == {b.id for b in batches}, name
    for s in ("1.00", "1.41", "0.71"):
        assert len(_by_name(f"extract.scale_{s}")) == n
    assert len(_by_name("index.flat.search")) == len(_by_name("rerank.qge1")) == n
    extract = {r.seconds for r in _by_name("serve.extract")}
    decode = {r.seconds for r in _by_name("serve.decode")}
    for _, timing in replies:
        assert timing["extract_s"] in extract and timing["prepare_s"] in decode
    summary = tracing.summary()["spans"]
    assert summary["serve.batch"]["self_s"] < summary["serve.batch"]["host_s"]


def test_tracing_changes_no_descriptor_or_ranking(solar):
    svc, paths = solar
    off = svc.query_batch(paths[:3])
    tracing.enable()
    on = svc.query_batch(paths[:3])
    assert [r for r, _ in on] == [r for r, _ in off]
    assert {k for _, t in on for k in t} == {"prepare_s", "extract_s", "search_s", "rerank_s",
                                             "batch", "slot"}
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    tracing.enable(False)
    v_off = svc._extract_fn(x)
    tracing.enable()
    v_on = svc._extract_fn(x)
    assert torch.equal(v_on, v_off)


def test_tracing_changes_no_loftr_count(tmp_path):
    from image_search_engine_for_historical_research_tpu_torch.models import loftr
    from image_search_engine_for_historical_research_tpu_torch.rerank import loftr_rerank

    m = loftr.init_matcher(device="cpu", initial_dim=16, block_dims=(16, 24, 32), d_coarse=32,
                           d_fine=16, nhead=4, coarse_layers=("self", "cross"), thr=0.0,
                           max_matches=32)
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    count = loftr.make_batched_count_fn(m)
    match = loftr.make_match_fn(m)
    off_counts, off_match = count(a, b), match(a[0], b[0])
    paths = write_images(str(tmp_path), 4, seed=9)
    ranks = np.array([[1, 2, 3]])
    kw = dict(b=3, resolution=(96, 64), pair_batch=2)
    off_order = loftr_rerank(paths[:1], paths, ranks, count_fn=count, **kw)
    tracing.enable()
    assert torch.equal(count(a, b), off_counts)
    for x, y in zip(match(a[0], b[0]), off_match):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(loftr_rerank(paths[:1], paths, ranks, count_fn=count, **kw),
                                  off_order)
    s = tracing.summary()["spans"]
    assert s["verify.rerank"]["count"] == 1 and s["verify.readback"]["count"] == 1
    assert s["verify.load"]["count"] == 4                     # the query and 3 candidates
    assert s["loftr.backbone"]["count"] == 1 + 1 + 2          # count, match, 2 blocks of 2
    assert s["loftr.fine"]["count"] == 1                      # the match only
    for name in ("loftr.backbone", "loftr.coarse_transformer", "loftr.select"):
        assert s[name]["device_s"] is None                    # no card
    (rr,) = _by_name("verify.rerank")
    assert {r.parent for r in _by_name("verify.load")} == {rr.id}


@pytest.mark.cuda
def test_device_spans_time_the_card_without_a_synchronise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch.cuda.is_available() is False")
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    tracing.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracing.span("card.outer", device=x.device):
            for _ in range(4):
                y = x @ x
            with tracing.span("card.inner", device="cuda"):
                y = y @ x
        with tracing.span("card.host"):
            pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s = tracing.summary()["spans"]
    assert s["card.outer"]["device_s"] > 0 and s["card.inner"]["device_s"] > 0
    assert s["card.outer"]["device_s"] > s["card.inner"]["device_s"]
    assert s["card.host"]["device_s"] is None
    assert torch.isfinite(y).all()
