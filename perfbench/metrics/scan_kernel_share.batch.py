"""``scan_kernel_share.batch``: the share of the batch step's scans that
ran the hand-written scan kernel: 100 x the count of the host spans
``ops.scan_topk`` (one a kernel launch) over the count of
``index.flat.search`` + ``rerank.qge1`` spans (one a scan). Read from the
port's span store (``perfbench/harness/spans.py``); 0.0 where the scans ran
and the kernel's span is absent (a port without the kernel)."""

from perfbench.harness.spans import span


def read(rec):
    scans = sum(s["count"] for s in (span(rec, "index.flat.search"), span(rec, "rerank.qge1"))
                if s is not None)
    if not scans:
        return None
    kernel = span(rec, "ops.scan_topk")
    return 100.0 * (kernel["count"] if kernel else 0) / scans
