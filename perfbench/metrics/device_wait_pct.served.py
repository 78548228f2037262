"""``device_wait_pct.served``: the share of the window in which the
service's device thread waited for the collector's next batch (the spans
``serve.device_wait``, summed, over ``window_s``). Read from the port's
span store (``perfbench/harness/spans.py``: the drivers' records do not
carry it)."""

from perfbench.harness.spans import span


def read(rec):
    s = span(rec, "serve.device_wait")
    if s is None or not rec.get("window_s"):
        return None
    return 100.0 * s["host_s"] / rec["window_s"]
