"""``rerank_ms.batch``: host clock around each qge1 call and its
read-back, mean."""


def read(rec):
    s = rec.get("rerank_s")
    return 1e3 * sum(s) / len(s) if s else None
