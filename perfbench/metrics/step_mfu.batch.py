"""``step_mfu.batch``: the whole batch step's share of the f32 peak: the
benchmark's FLOPs of both scans of every batch (the search's and qge1's,
``perfbench/flops``) over the window."""

from perfbench.harness.readers import mfu_pct


def read(rec):
    fb, n = rec.get("scan_flops_bytes"), rec.get("batches_done")
    if not fb or not n or not rec.get("window_s"):
        return None
    return mfu_pct(2 * n * fb[0], rec["window_s"])
