"""``requests_per_batch.served``: the coalescer's own counters
(``requests_served / batches_run``) over the window."""


def read(rec):
    if not rec.get("batches_run"):
        return None
    return rec["requests_served"] / rec["batches_run"]
