"""``search_ms.served``: the exact search of a batch (``SearchService``
timing ``search_s``, ended by the shortlist's read-back), mean over
batches."""

from perfbench.harness.readers import batch_mean


def read(rec):
    m = batch_mean(rec, lambda t: t["search_s"])
    return None if m is None else 1e3 * m
