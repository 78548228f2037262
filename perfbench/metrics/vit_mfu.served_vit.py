"""``vit_mfu.served_vit``: the whole descriptor step's share of the f32
peak: the benchmark's FLOPs of every answered upload over its valid tokens
at every scale (``perfbench/flops``), over the summed device time of the
spans ``vit.forward`` (each scale's forward of each batch, slot padding
and padded tokens included). Read from the port's span store
(``perfbench/harness/spans.py``)."""

from perfbench.harness.readers import mfu_pct
from perfbench.harness.spans import span


def read(rec):
    s, flops = span(rec, "vit.forward"), rec.get("upload_flops")
    if s is None or s["device_s"] is None or not flops:
        return None
    return mfu_pct(flops, s["device_s"])
