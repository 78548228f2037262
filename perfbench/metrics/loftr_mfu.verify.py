"""``loftr_mfu.verify``: the matcher's whole count step over the window:
the benchmark's FLOPs of a block of pairs (``perfbench/flops``) times the
blocks run, over the window, against the f32 peak."""

from perfbench.harness.readers import mfu_pct


def read(rec):
    if not rec.get("blocks_run") or not rec.get("block_flops"):
        return None
    return mfu_pct(rec["blocks_run"] * rec["block_flops"], rec["window_s"])
