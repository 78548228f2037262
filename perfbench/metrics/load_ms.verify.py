"""``load_ms.verify``: the host's seconds reading and resizing a request's
images (the spans ``verify.load``, summed) per ``loftr_rerank`` call (the
span ``verify.rerank``). Read from the port's span store
(``perfbench/harness/spans.py``: the drivers' records do not carry it)."""

from perfbench.harness.spans import span


def read(rec):
    load, rerank = span(rec, "verify.load"), span(rec, "verify.rerank")
    if load is None or rerank is None:
        return None
    return 1e3 * load["host_s"] / rerank["count"]
