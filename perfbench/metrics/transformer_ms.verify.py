"""``transformer_ms.verify``: device milliseconds a block of pairs spends
in the positional encoding and the coarse transformer's layers (the
device span ``loftr.coarse_transformer``, CUDA events), mean over the
window's blocks. Read from the port's span store
(``perfbench/harness/spans.py``: the drivers' records do not carry it)."""

from perfbench.harness.spans import device_ms_per_span


def read(rec):
    return device_ms_per_span(rec, "loftr.coarse_transformer")
