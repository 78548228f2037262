"""``extract_mfu.served``: the whole descriptor step's share of the f32
peak: the benchmark's FLOPs of every batch at its padded slot over its
scales (``perfbench/flops``), over the summed ``extract_s``."""

from perfbench.harness.readers import mfu_pct


def read(rec):
    t, f = rec.get("timings"), rec.get("canvas_flops")
    if not t or not f:
        return None
    flops = sum(x["slot"] * f / x["batch"] for x in t)
    return mfu_pct(flops, sum(x["extract_s"] / x["batch"] for x in t))
