"""The span readers: each gives its value from a record with ``trace`` set
and a span store filled by hand, and nothing without ``trace``."""

import pytest

from image_search_engine_for_historical_research_tpu_torch.utils import tracing
from perfbench.harness import core

SPANS = {
    "serve.queue": (4, 0.2, None),
    "serve.device_wait": (9, 1.5, None),
    "extract.scale_1.00": (3, 0.3, 0.24),
    "extract.scale_1.41": (3, 0.6, 0.48),
    "extract.scale_0.71": (3, 0.15, 0.12),
    "verify.load": (120, 0.6, None),
    "verify.rerank": (2, 4.0, None),
    "loftr.backbone": (30, 3.0, 2.7),
    "loftr.coarse_transformer": (30, 0.6, 0.45),
    "loftr.select": (30, 0.5, 0.3),
    "index.flat.search": (5, 0.06, 0.05),
    "rerank.qge1": (5, 0.07, 0.055),
}
REC = {"trace": {"busy_s": 1.0, "window_s": 10.0}, "window_s": 10.0, "requests_served": 40}
EXPECT = {
    "queue_wait_ms.served": 50.0,
    "device_wait_pct.served": 15.0,
    "extract_scale_1_ms.served": 6.0,
    "extract_scale_sqrt2_ms.served": 12.0,
    "extract_scale_rsqrt2_ms.served": 3.0,
    "load_ms.verify": 300.0,
    "backbone_ms.verify": 90.0,
    "transformer_ms.verify": 15.0,
    "select_ms.verify": 10.0,
    "scan_device_ms.batch": 10.0,
    "qge1_device_ms.batch": 11.0,
}


@pytest.fixture
def filled(monkeypatch):
    summary = {"spans": {n: {"count": c, "host_s": h, "self_s": h, "device_s": d}
                         for n, (c, h, d) in SPANS.items()}, "dropped": 0}
    monkeypatch.setattr(tracing, "summary", lambda: summary)


def test_every_span_metric_is_in_the_benchmark_and_reads_the_store():
    names = {m["name"]: m for m in core.load_benchmark()["per_layer"]}
    for n in EXPECT:
        assert names[n]["source"] == "program_span" and len(names[n]["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_gives_its_value_from_the_store(filled, name):
    read = core.load_part("metrics", name).read
    assert read(REC) == pytest.approx(EXPECT[name])
    assert read({**REC, "trace": None}) is None


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing_in_an_empty_store(name):
    tracing.reset()
    assert core.load_part("metrics", name).read(REC) is None


def test_host_readers_read_spans_the_port_stored():
    tracing.reset()
    tracing.enable()
    try:
        for i in range(4):
            tracing.record("serve.queue", 0, (i + 1) * 10_000_000, request=i)
        for _ in range(2):
            with tracing.span("verify.rerank"):
                with tracing.span("verify.load"):
                    pass
    finally:
        tracing.enable(False)
    loads = sum(r.seconds for r in tracing.spans() if r.name == "verify.load")
    try:
        assert core.load_part("metrics", "queue_wait_ms.served").read(REC) == pytest.approx(25.0)
        assert core.load_part("metrics", "load_ms.verify").read(REC) == pytest.approx(
            1e3 * loads / 2)
        assert core.load_part("metrics", "backbone_ms.verify").read(REC) is None
    finally:
        tracing.reset()
