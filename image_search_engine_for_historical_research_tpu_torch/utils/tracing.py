"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name, device=False, **attrs)`` brackets a block of work. Its
``.seconds`` (``time.perf_counter``) is always measured, so a caller can
report it. While tracing is on, a span also

- enters ``torch.profiler.record_function(name)``, so a profiler trace
  shows it and can name the device's idle gaps by it;
- records its start and end on ``time.time_ns()``, the clock of
  ``torch.profiler``'s host events, so both lie on one time line;
- records its thread's name, its parent (the innermost span open on the
  same thread) and ``attrs`` (``request=``, ``rows=``, ...);
- with ``device`` (the device its work runs on) a CUDA device, records a
  pair of timing events on that device's current stream. They are read
  only by ``summary()``: a span never synchronises the device.

``record(name, start_ns, end_ns, **attrs)`` stores a span that starts on
one thread and ends on another (a request's wait in a queue).

Tracing is on while ``enable()`` is in force or a ``torch.profiler``
profile runs in the process: ``torch.autograd.profiler._is_profiler_enabled``
is the Python global that every thread sees (the C flag is per thread),
so a traced window turns the spans on from every thread. A span is stored
only if tracing was on at both of its ends. Off, a span makes one flag
check and two ``perf_counter`` reads, and nothing else.

The store is in memory, capped at ``MAX_SPANS`` (``summary()`` says how
many spans it dropped); ``reset()`` empties it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 200_000

_enabled = False
_lock = threading.Lock()
_store: List["Record"] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn tracing on (or, with ``on=False``, back to following the
    profiler)."""
    global _enabled
    _enabled = bool(on)


def is_on() -> bool:
    return _enabled or getattr(_profiler, "_is_profiler_enabled", False)


class Record:
    """One stored span. ``seconds`` is the span's ``.seconds`` (or, for
    ``record``, ``(end_ns - start_ns) / 1e9``)."""

    __slots__ = ("id", "parent", "name", "thread", "start_ns", "end_ns", "seconds", "attrs",
                 "_events", "_device_s")

    def __init__(self, id, parent, name, thread, start_ns, end_ns, seconds, attrs, events=None):
        self.id, self.parent, self.name, self.thread = id, parent, name, thread
        self.start_ns, self.end_ns, self.seconds, self.attrs = start_ns, end_ns, seconds, attrs
        self._events = events
        self._device_s: Optional[float] = None

    @property
    def device_seconds(self) -> Optional[float]:
        """Device time between the span's two events (waits for the end
        event the first time it is read); ``None`` for a host span."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self._events = None
        return self._device_s


def _keep(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_store) < MAX_SPANS:
            _store.append(rec)
        else:
            _dropped += 1


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _cuda_stream(device):
    if not device:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


class span:
    """Context manager; see the module's docstring."""

    __slots__ = ("name", "device", "attrs", "seconds", "_t0", "_on", "_id", "_parent", "_rf",
                 "_stream", "_events", "_start_ns")

    def __init__(self, name: str, device=False, **attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.seconds = 0.0

    def __enter__(self):
        self._on = is_on()
        if self._on:
            self._begin()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._on:
            self._end()
        return False

    def _begin(self) -> None:
        stack = _stack()
        self._id = next(_ids)
        self._parent = stack[-1] if stack else None
        stack.append(self._id)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._stream = _cuda_stream(self.device)
        self._events = None
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._start_ns = time.time_ns()

    def _end(self) -> None:
        end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        self._rf.__exit__(None, None, None)
        _stack().pop()
        if is_on():
            _keep(Record(self._id, self._parent, self.name, threading.current_thread().name,
                         self._start_ns, end_ns, self.seconds, self.attrs, self._events))


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Store a span timed by the caller on ``time.time_ns()`` (no parent,
    no device time), when tracing is on."""
    if is_on():
        _keep(Record(next(_ids), None, name, threading.current_thread().name, start_ns, end_ns,
                     (end_ns - start_ns) / 1e9, attrs))


def spans() -> List[Record]:
    """The stored spans, in the order they ended."""
    with _lock:
        return list(_store)


def summary() -> Dict[str, Any]:
    """``{"spans": {name: {"count", "host_s", "self_s", "device_s"}},
    "dropped": n}``. ``self_s`` is a span's seconds less those of its
    children (spans opened inside it on its thread); ``device_s`` is
    ``None`` where no span of the name timed the device."""
    with _lock:
        recs, dropped = list(_store), _dropped
    covered: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            covered[r.parent] += r.seconds
    out: Dict[str, Dict[str, Any]] = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": None})
        s["count"] += 1
        s["host_s"] += r.seconds
        s["self_s"] += r.seconds - covered.get(r.id, 0.0)
        d = r.device_seconds
        if d is not None:
            s["device_s"] = (s["device_s"] or 0.0) + d
    return {"spans": out, "dropped": dropped}


def reset() -> None:
    """Empty the store."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
