"""The ``scan_kernel_share.batch`` reader on a seeded span store: 100 with
a kernel span a scan, 0.0 where the scans ran without the kernel (a port
without it), ``None`` without a trace."""

import pytest

from image_search_engine_for_historical_research_tpu_torch.utils import tracing
from perfbench.harness import core

REC = {"trace": {"busy_s": 1.0, "window_s": 10.0}, "window_s": 10.0}


@pytest.mark.parametrize("case,want", [("kernel", 100.0), ("no_kernel", 0.0),
                                       ("untraced", None)])
def test_scan_kernel_share_reads_the_kernel_spans_over_the_scans(case, want):
    tracing.reset()
    tracing.enable()
    try:
        for _ in range(3):  # three batch steps: a search and a qge1 each
            for name in ("index.flat.search", "rerank.qge1"):
                with tracing.span(name):
                    if case != "no_kernel":
                        with tracing.span("ops.scan_topk", q=70, k=100):
                            pass
    finally:
        tracing.enable(False)
    rec = {**REC, "trace": None} if case == "untraced" else REC
    try:
        assert core.load_part("metrics", "scan_kernel_share.batch").read(rec) == want
    finally:
        tracing.reset()


def test_scan_kernel_share_is_in_the_benchmark_for_the_batch_cell():
    m = {m["name"]: m for m in core.load_benchmark()["per_layer"]}["scan_kernel_share.batch"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_span", "kernel", "batch_queries_per_s", ["solar-r1m.batch-q70"])
