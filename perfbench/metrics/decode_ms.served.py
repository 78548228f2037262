"""``decode_ms.served``: the host's decode and canvas packing a batch
(``SearchService`` timing ``prepare_s``), mean over batches."""

from perfbench.harness.readers import batch_mean


def read(rec):
    m = batch_mean(rec, lambda t: t["prepare_s"])
    return None if m is None else 1e3 * m
