"""``queue_wait_ms.served``: each upload's wait in ``CoalescingService``'s
queue, enqueued to the drain that takes it (the span ``serve.queue``),
mean. Read from the port's span store (``perfbench/harness/spans.py``:
the drivers' records do not carry it)."""

from perfbench.harness.spans import span


def read(rec):
    s = span(rec, "serve.queue")
    return None if s is None else 1e3 * s["host_s"] / s["count"]
