"""``batch_queries_per_s``: queries whose final top-K came back, over the
window (which ends at the end of the last batch it started)."""


def read(rec):
    if not rec.get("window_s") or "queries_done" not in rec:
        return None
    return rec["queries_done"] / rec["window_s"]
