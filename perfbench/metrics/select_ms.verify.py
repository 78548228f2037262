"""``select_ms.verify``: device milliseconds a block of pairs spends in the
dual softmax, the mutual maxima, the top matches and their keypoints (the
device span ``loftr.select``, CUDA events), mean over the window's
blocks. Read from the port's span store (``perfbench/harness/spans.py``:
the drivers' records do not carry it)."""

from perfbench.harness.spans import device_ms_per_span


def read(rec):
    return device_ms_per_span(rec, "loftr.select")
