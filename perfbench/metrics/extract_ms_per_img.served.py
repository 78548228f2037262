"""``extract_ms_per_img.served``: the descriptor's seconds (``extract_s``,
ended by a synchronise) summed over batches, a real request."""


def read(rec):
    t = rec.get("timings")
    if not t:
        return None
    return 1e3 * sum(x["extract_s"] / x["batch"] for x in t) / len(t)
