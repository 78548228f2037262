"""``vit_mlp_ms.served_vit``: device milliseconds of the ViT's spans
``vit.mlp`` (CUDA events) summed over the window, over the requests
served. Read from the port's span store (``perfbench/harness/spans.py``)."""

from perfbench.harness.spans import device_ms_per_request


def read(rec):
    return device_ms_per_request(rec, "vit.mlp")
