"""``extract_scale_rsqrt2_ms.served``: the descriptor's forward at scale
1/sqrt 2 (the device span ``extract.scale_0.71``, CUDA events), summed over
the window's batches, over the requests served: the form of
``extract_ms_per_img.served``. Read from the port's span store
(``perfbench/harness/spans.py``: the drivers' records do not carry it)."""

from perfbench.harness.spans import device_ms_per_request


def read(rec):
    return device_ms_per_request(rec, "extract.scale_0.71")
