"""``verify_pairs_per_s``: query-candidate pairs whose counts came back,
over the window (which ends at the end of the last request it started)."""


def read(rec):
    if not rec.get("window_s") or "pairs_done" not in rec:
        return None
    return rec["pairs_done"] / rec["window_s"]
