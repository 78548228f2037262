"""The traced window: ``torch.profiler`` over CPU and CUDA, reduced to the
device's busy seconds, the window's length, the device operations that
took most time, and the longest idle gaps named by what the host was
doing (the innermost host event that covers the gap's middle)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of ``(start, end)`` intervals, sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                  window: Tuple[int, int], top: int = 10) -> Dict[str, Any]:
    """``device`` and ``host``: ``(name, start_ns, end_ns)`` events; ``window``
    the traced window's ``(start_ns, end_ns)``. Returns busy seconds, the
    window's seconds, per-kernel seconds, and the ``top`` device operations
    and idle-gap causes by seconds."""
    ws, we = window
    clipped = [(max(s, ws), min(e, we)) for _, s, e in device if e > ws and s < we]
    busy_iv = merge(clipped)
    busy_ns = sum(e - s for s, e in busy_iv)
    per_op: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        if e > ws and s < we:
            per_op[name] += (min(e, we) - max(s, ws)) / 1e9
    gaps = []
    cur = ws
    for s, e in busy_iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if we > cur:
        gaps.append((cur, we))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((s, e, n) for n, s, e in host if n != WINDOW_SPAN)
    starts = [h[0] for h in host]
    by_cause: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps[:500]:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid)
        best: Optional[Tuple[int, str]] = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = host[j]
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, n)
        by_cause[best[1] if best else "host: no traced op"] += (ge - gs) / 1e9
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])
    causes = sorted(by_cause.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (we - ws) / 1e9,
        "kernels_s": dict(per_op),
        "device_ops": [[n, v] for n, v in ops[:top]],
        "idle_gaps": [[n, v] for n, v in causes[:top]],
        "n_device_events": len(device),
    }


class Tracer:
    """Context manager; does nothing when ``enabled`` is false."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._span = None
        self.reduce_s: Optional[float] = None
        self._summary: Optional[Dict[str, Any]] = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._span = record_function(WINDOW_SPAN)
            self._span.__enter__()
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        t0 = time.perf_counter()
        self._summary = self._reduce()
        self.reduce_s = time.perf_counter() - t0
        self._prof = None
        return False

    def _reduce(self) -> Dict[str, Any]:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        window = None
        for ev in events:
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                annotation = getattr(ev, "is_user_annotation", None)
                if not (name == WINDOW_SPAN or (annotation is not None and annotation())):
                    device.append((name, s, e))      # kernels, copies and sets
            else:
                if name == WINDOW_SPAN:
                    window = (s, e)
                host.append((name, s, e))
        if window is None:
            raise RuntimeError("the profiler's trace holds no window span")
        out = reduce_events(device, host, window)
        if out["busy_s"] <= 0:
            raise RuntimeError("the profiler's trace holds no device operation in the window")
        return out

    def summary(self) -> Optional[Dict[str, Any]]:
        if self._summary is not None:
            self._summary["reduce_s"] = self.reduce_s
        return self._summary
