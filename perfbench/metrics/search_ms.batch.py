"""``search_ms.batch``: host clock around each ``FlatIndex.search`` call
and its read-back, mean."""


def read(rec):
    s = rec.get("search_s")
    return 1e3 * sum(s) / len(s) if s else None
