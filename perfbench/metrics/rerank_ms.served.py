"""``rerank_ms.served``: qge1 over a batch's shortlists (``SearchService``
timing ``rerank_s``, ended by the lists' read-back), mean over batches."""

from perfbench.harness.readers import batch_mean


def read(rec):
    m = batch_mean(rec, lambda t: t["rerank_s"])
    return None if m is None else 1e3 * m
