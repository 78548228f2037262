"""Request coalescing (micro-batching) for the online service.

Port of ``image_search_engine_for_historical_research_tpu/serving/batching.py``
(all of it; pure Python, plus the spans below). ``CoalescingService`` wraps a
``SearchService`` with a two-stage pipeline:

  requests -> [collector thread: drain <= max_batch, host decode/pack
               (``SearchService.prepare_batch``)] -> depth-1 handoff ->
              [device thread: ``execute_batch`` -> distribute results]

so the host half of batch N+1 (JPEG decode, canvas packing) overlaps the
device half of batch N. ``prepare_batch`` is numpy and PIL only: nothing on
the collector thread touches the card. Under load the next batch forms while
the previous one runs; a lone request still goes at once after at most
``max_wait_ms``. It has ``query_image`` like the service, so
``make_wsgi_app`` serves it unchanged; pair it with ``serve(...,
threaded=True)`` so concurrent HTTP requests reach the queue together.

Spans (``utils.tracing``): ``serve.queue`` (each request, enqueued to
drained), ``serve.coalesce`` (the drain waiting for a batch to fill),
``serve.handoff`` (the collector blocked on the full hand-off),
``serve.device_wait`` (the device thread waiting for a batch),
``serve.batch`` (one batch's ``execute_batch``) and ``serve.reply``.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Optional

from ..utils import tracing


class _Pending:
    __slots__ = ("id", "path", "event", "result", "error", "enqueued_ns")

    def __init__(self, id: int, path: str):
        self.id = id
        self.path = path
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued_ns = time.time_ns()


def _fail(batch, err):
    for req in batch:
        req.error = err
        req.event.set()


class CoalescingService:
    """Micro-batching front for ``SearchService`` (same query interface).

    Attributes ``requests_served`` / ``batches_run`` expose the coalescing
    ratio (requests/batch > 1 under concurrent load). ``pipeline=False``
    disables the prepare/execute overlap (one thread does both, in order).
    """

    def __init__(
        self,
        service,
        max_batch: int = 16,
        max_wait_ms: float = 3.0,
        pipeline: bool = True,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._svc = service
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.pipeline = bool(pipeline)
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self._ids = itertools.count()
        self.requests_served = 0
        self.batches_run = 0
        self._handoff: "queue.Queue" = queue.Queue(maxsize=1)
        self._threads = [
            threading.Thread(
                target=self._collect, name="serving-collector", daemon=True
            )
        ]
        if self.pipeline:
            self._threads.append(
                threading.Thread(
                    target=self._device_loop, name="serving-device", daemon=True
                )
            )
        for t in self._threads:
            t.start()

    # same duck-typed surface the WSGI app uses
    def __getattr__(self, name):
        return getattr(self._svc, name)

    def query_image(self, image_path: str):
        req = _Pending(next(self._ids), image_path)
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.append(req)
            self._lock.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    # ------------------------------------------------------------- pipeline

    def _drain(self) -> Optional[list]:
        """Block for the next request burst; None when closing."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if self._closed and not self._queue:
                return None
            # brief coalescing window: let a burst accumulate, but never
            # hold a full batch (under sustained load the queue refills
            # while the previous batch is in flight)
            with tracing.span("serve.coalesce"):
                deadline = time.monotonic() + self.max_wait_s
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._lock.wait(remaining)
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
        now = time.time_ns()
        for req in batch:
            tracing.record("serve.queue", req.enqueued_ns, now, request=req.id)
        return batch

    def _collect(self):
        while True:
            batch = self._drain()
            if batch is None:
                if self.pipeline:
                    self._handoff.put(None)  # device-loop shutdown
                return
            try:
                prepared = self._svc.prepare_batch([r.path for r in batch])
            except BaseException:
                # one bad upload (corrupt JPEG, vanished temp file) must not
                # fail the other coalesced requests: probe each request's
                # decode alone, fail only the offenders, re-prepare the rest
                batch = self._isolate_failures(batch)
                if not batch:
                    continue
                try:
                    prepared = self._svc.prepare_batch(
                        [r.path for r in batch]
                    )
                except BaseException as e:  # non-decode batch-level failure
                    _fail(batch, e)
                    continue
            if self.pipeline:
                with tracing.span("serve.handoff"):
                    self._handoff.put((batch, prepared))
            else:
                self._execute(batch, prepared)

    def _isolate_failures(self, batch):
        """Per-request decode probe after a batch prepare failed; returns the
        surviving requests (offenders get their individual error set)."""
        ok = []
        for req in batch:
            try:
                self._svc.prepare_batch([req.path])
            except BaseException as e:
                req.error = e
                req.event.set()
            else:
                ok.append(req)
        return ok

    def _device_loop(self):
        while True:
            with tracing.span("serve.device_wait"):
                item = self._handoff.get()
            if item is None:
                return
            self._execute(*item)

    def _execute(self, batch, prepared):
        try:
            with tracing.span("serve.batch", requests=[r.id for r in batch], rows=len(batch)):
                out = self._svc.execute_batch(prepared)
        except BaseException as e:
            _fail(batch, e)
            return
        finally:
            with self._lock:
                self.batches_run += 1
                self.requests_served += len(batch)
        with tracing.span("serve.reply"):
            for req, res in zip(batch, out):
                req.result = res
                req.event.set()
