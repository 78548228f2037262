"""``vit_attention_roofline.served_vit``: the attention kernel's share of
its roofline, whichever kernel implements it: the benchmark's FLOPs of
every answered upload's attention cores over its valid tokens
(``4 N^2 D`` a block, ``perfbench/flops``), over the summed device time of
the spans ``vit.attention_core`` (the masked ``softmax(q kᵀ) v`` alone),
against the f32 peak (the products are f32, so the peak bounds them).
Read from the port's span store (``perfbench/harness/spans.py``)."""

from perfbench.harness.readers import mfu_pct
from perfbench.harness.spans import span


def read(rec):
    s, flops = span(rec, "vit.attention_core"), rec.get("attention_flops")
    if s is None or s["device_s"] is None or not flops:
        return None
    return mfu_pct(flops, s["device_s"])
