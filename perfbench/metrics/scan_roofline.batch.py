"""``scan_roofline.batch``: the exact scan's (score GEMM + top-k)
least time, the larger of its FLOPs over the f32 peak and its bytes over
HBM's (``perfbench/flops``), over the CUDA-event time around the call."""

from perfbench.harness.peaks import F32_FLOPS, HBM_BYTES_PER_S


def read(rec):
    ev, fb = rec.get("scan_event_s"), rec.get("scan_flops_bytes")
    if not ev or not fb:
        return None
    least = max(fb[0] / F32_FLOPS, fb[1] / HBM_BYTES_PER_S)
    return 100.0 * least * len(ev) / sum(ev)
