"""The port's span store (``utils/tracing.py``), as the span readers see it.

The drivers' records do not carry ``tracing.summary()``, so a span reader
reads the store of the process that ran the cell. Spans are stored only
while tracing is on, which in a run is the traced window (``--trace 1``:
the profiler's window turns them on from every thread), so the store
holds that window's spans and nothing of set-up or of the checks. A
reader finds nothing without ``rec["trace"]``, on a port without the
tracing module, or where no span of the name was stored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def span(rec, name: str) -> Optional[Dict[str, Any]]:
    """``{"count", "host_s", "self_s", "device_s"}`` of the spans ``name``."""
    if not rec.get("trace"):
        return None
    try:
        from image_search_engine_for_historical_research_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary()["spans"].get(name)
    return s if s and s["count"] else None


def device_ms_per_span(rec, name: str) -> Optional[float]:
    """Mean device milliseconds of a span ``name``."""
    s = span(rec, name)
    if s is None or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["count"]


def device_ms_per_request(rec, name: str) -> Optional[float]:
    """Device milliseconds of the spans ``name`` over the requests served."""
    s = span(rec, name)
    if s is None or s["device_s"] is None or not rec.get("requests_served"):
        return None
    return 1e3 * s["device_s"] / rec["requests_served"]
