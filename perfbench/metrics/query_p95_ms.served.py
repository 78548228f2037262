"""``query_p95_ms.served``: the 95th percentile (nearest rank) of every
upload's wait from its due time to its ranked list, failed requests
counted as missing it. Above the knee the queue grows through the window,
so this tail swings with the smallest change: a per-layer reading beside
``uploads_per_s``, not a bounded one."""

from perfbench.harness.readers import percentile


def read(rec):
    lat = rec.get("latencies_s")
    p = percentile(lat, 95.0) if lat else None
    return None if p is None else 1e3 * p
