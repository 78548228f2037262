"""``scan_device_ms.batch``: device milliseconds of a ``FlatIndex.search``
call (the device span ``index.flat.search``, CUDA events; no read-back),
mean. Read from the port's span store (``perfbench/harness/spans.py``:
the drivers' records do not carry it)."""

from perfbench.harness.spans import device_ms_per_span


def read(rec):
    return device_ms_per_span(rec, "index.flat.search")
