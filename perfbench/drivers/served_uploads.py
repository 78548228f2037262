"""Open-loop uploads to a served collection.

The system under test is the port's online service as ``cli.online
--matching-method L2 --coalesce`` builds it: ``make_wsgi_app`` over
``CoalescingService`` over ``SearchService`` (the descriptor, the exact
``FlatIndex`` over the gallery, one qge1 iteration). Client threads call
the WSGI app in process with ``POST /`` multipart bodies and ``Accept:
application/json``, on a Poisson schedule fixed by the traffic mix (the
exponential distribution's quantiles as gaps, in an order stratified in
blocks and drawn from the mix's ``schedule_seed``, the same for every run
seed), with a seeded order of the photographs of the pool, each used as
often as the others. Each request is timed from the moment it was due,
not from when it was sent.

What the timed path produced is checked after the window, stage by stage
from the program's own state: every descriptor the service searched with
(recorded by the index it was handed) against the exact top-K of the plain
reference, every answer's qge1 list against the reference's qge1 from the
program's shortlist, and the descriptors of a seeded sample of uploads
against the reference's descriptor of the same JPEG bytes.
"""

from __future__ import annotations

import io
import json
import math
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.harness import photos
from perfbench.harness.core import Outcome, apply_precision, checks
from perfbench.harness.seeds import rng

BOUNDARY = "perfbenchboundary7f3a"


def multipart(jpeg: bytes) -> bytes:
    return (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"upload.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n").encode() \
        + jpeg + f"\r\n--{BOUNDARY}--\r\n".encode()


def arrivals(seed: int, rate: float, seconds: float, block: int = 16) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    Poisson arrivals: the exponential's quantiles as gaps, so every seed
    offers the same gaps, in an order drawn from ``seed`` and stratified: each run
    of ``block`` arrivals draws one gap from each of ``block`` strata of
    the distribution, so every stretch of the window offers the same load
    and a seed moves the bursts within a block, not the queue across the
    window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate          # ascending
    r = rng(seed, "served.arrivals")
    stratum = np.arange(n) * block // n
    slot = np.empty(n, np.int64)
    for s in range(block):
        members = np.flatnonzero(stratum == s)
        slot[members] = r.permutation(len(members))
    order = np.lexsort((r.random(n), slot))                      # by block, shuffled within
    return np.cumsum(gaps[order])


def choices(seed: int, n: int, pool: int) -> np.ndarray:
    """Which photograph each request uploads: the pool tiled, then shuffled."""
    return rng(seed, "served.choices").permutation(np.resize(np.arange(pool), n))


@dataclass
class Reply:
    ok: bool
    latency_s: float
    ids: List[int] = field(default_factory=list)
    timing: Dict[str, Any] = field(default_factory=dict)
    error: str = ""
    late_s: float = 0.0          # how long after its due time it was sent


def post(app, body: bytes, due: float) -> Reply:
    """One ``POST /`` through the WSGI app; latency from ``due``."""
    late = time.perf_counter() - due
    status: List[str] = []
    environ = {
        "REQUEST_METHOD": "POST", "PATH_INFO": "/", "SERVER_NAME": "bench",
        "SERVER_PORT": "80", "wsgi.url_scheme": "http",
        "CONTENT_TYPE": f"multipart/form-data; boundary={BOUNDARY}",
        "CONTENT_LENGTH": str(len(body)), "HTTP_ACCEPT": "application/json",
        "wsgi.input": io.BytesIO(body),
    }
    try:
        out = b"".join(app(environ, lambda s, h: status.append(s)))
        done = time.perf_counter()
        if not status or not status[0].startswith("200"):
            return Reply(False, done - due, error=f"{status[:1]} {out[:200]!r}", late_s=late)
        payload = json.loads(out)
        return Reply(True, done - due, [int(r["id"]) for r in payload["results"]],
                     payload["timing"], late_s=late)
    except Exception as e:  # a failed request counts as missing every limit
        return Reply(False, time.perf_counter() - due, error=repr(e), late_s=late)


def _recording_index(index):
    """The service's ``FlatIndex``, recording each search's queries and ids
    (references only: no copy and no synchronisation on the timed path)."""
    cls = type(index)

    class Recording(cls):
        def search(self, queries, k, *args, **kwargs):
            s, i = super().search(queries, k, *args, **kwargs)
            self.log.append((queries, i))
            return s, i

    rec = Recording(vectors=index.vectors, metric=index.metric,
                    storage_dtype=index.storage_dtype)
    rec.log = []
    return rec


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: str
    pool: Any
    sd: dict
    index: Any
    service: Any
    front: Any
    app: Any
    bodies: List[bytes]
    tmp: Any


def setup(ctx) -> State:
    """Inputs from the seed, the system built on them, every batch slot
    warmed."""
    from image_search_engine_for_historical_research_tpu_torch.index.flat import build_flat
    from image_search_engine_for_historical_research_tpu_torch.serving.app import (
        SearchService,
        make_wsgi_app,
    )
    from image_search_engine_for_historical_research_tpu_torch.serving.batching import (
        CoalescingService,
    )

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    apply_precision(cfg)
    system = ctx.system()
    pool = photos.make_pool(ctx.seed, tr["pool"], tr["scenes"], tr["sizes_hw"],
                            tr["jpeg_quality"], dev)
    sd = system.state_dict(cfg, ctx.seed, dev)
    model = system.build_model(cfg, sd, dev)
    gallery = system.make_gallery(cfg, ctx.seed, dev)
    host = gallery.cpu().numpy()
    icfg = cfg["index"]
    index = _recording_index(build_flat(gallery, metric=icfg["metric"],
                                        storage_dtype=icfg["storage_dtype"], device=dev))
    del gallery
    service = SearchService(model, index, host, system.gallery_paths(cfg), K=tr["K"],
                            scales=tuple(cfg["scales"]), image_size=cfg["image_size"],
                            rerank=cfg["rerank"]["method"], device=dev)
    front = CoalescingService(service, max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"])
    app = make_wsgi_app(front)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-served-")
    warm = photos.write_pool(pool.jpegs[:tr["max_batch"]], tmp.name)
    for slot in service.BATCH_SLOTS:
        if slot <= tr["max_batch"]:
            for _ in range(2):
                service.execute_batch(service.prepare_batch(warm[:slot]))
    bodies = [multipart(j) for j in pool.jpegs]
    for b in bodies[:2]:
        post(app, b, time.perf_counter())
    ctx.sync()
    index.log.clear()
    return State(cfg, tr, ctx.seed, dev, pool, sd, index, service, front, app, bodies, tmp)


def drive(st: State, rate: float, seconds: float, seed: int) -> Dict[str, Any]:
    """The open loop: every request due in the window is sent at its time
    (or as soon after as a client thread is free) and waited for, up to a
    minute past the window's close. The schedule comes from the traffic
    mix's own ``schedule_seed``, the same for every run seed: a run's seed
    picks the photographs (and the weights and the gallery), not the
    queue."""
    due = arrivals(st.traffic["schedule_seed"], rate, seconds)
    pick = choices(seed, len(due), len(st.bodies))
    served0, batches0 = st.front.requests_served, st.front.batches_run
    ex = ThreadPoolExecutor(st.traffic["client_threads"], thread_name_prefix="client")
    futures = []
    t0 = time.perf_counter() + 0.01
    for d, j in zip(due, pick):
        at = t0 + float(d)
        pause = at - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        futures.append(ex.submit(post, st.app, st.bodies[j], at))
    done, pending = wait(futures, timeout=max(0.0, t0 + seconds + 60 - time.perf_counter()))
    ex.shutdown(wait=not pending, cancel_futures=True)
    replies = [f.result() if f in done else Reply(False, math.inf, error="no reply")
               for f in futures]
    done_s = [float(d) + r.latency_s for d, r in zip(due, replies) if r.ok]
    in_window = [x for x in done_s if x <= seconds]
    return {"replies": replies, "choices": pick, "due_s": due,
            "lateness_s": [r.late_s for r in replies],
            "window_s": max([seconds] + done_s),
            "completed_in_window": len(in_window),
            "last_completion_s": max(in_window, default=0.0),
            "requests_served": st.front.requests_served - served0,
            "batches_run": st.front.batches_run - batches0}


def close(st: State) -> None:
    st.front.close()
    st.service.close()
    st.tmp.cleanup()


def record(ctx, st: State, out: Dict[str, Any]) -> Dict[str, Any]:
    """What the metric readers read."""
    fl = ctx.flops()
    side = -(-st.cfg["image_size"] // 32) * 32
    replies = out["replies"]
    return {
        "setup_s": ctx.setup_s,
        "latencies_s": [r.latency_s if r.ok else math.inf for r in replies],
        "lateness_s": out["lateness_s"],
        "window_s": out["window_s"],
        "completed_in_window": out["completed_in_window"],
        "last_completion_s": out["last_completion_s"],
        "timings": [r.timing for r in replies if r.ok],
        "requests_served": out["requests_served"],
        "batches_run": out["batches_run"],
        "canvas_flops": fl.descriptor_flops(side, st.cfg["scales"], st.cfg["architecture"],
                                            st.cfg["soa_layers"]),
        "trace": ctx.trace_summary,
    }


def readings(ctx, st: State, out: Dict[str, Any], control: bool = False) -> Dict[str, float]:
    """The compared numbers. With ``control`` the reference in TF32 stands
    in the program's place: its descriptors for the sampled uploads, its
    shortlists and qge1 lists for the recorded rows."""
    ref = ctx.reference()
    cfg, tr, dev = st.cfg, st.traffic, st.device
    K, k_qe, w_qe = tr["K"], cfg["rerank"]["k"], cfg["rerank"]["w"]
    q_rows = torch.cat([q for q, _ in st.index.log]).float()
    s_rows = torch.cat([i for _, i in st.index.log])
    gallery = ref.normalize_rows(ctx.system().make_gallery(cfg, st.seed, dev))
    replies = out["replies"]
    ok = [i for i, r in enumerate(replies) if r.ok]
    with ref.precision(False):
        q_unit = ref.unit(q_rows)
        if control:
            with ref.precision(True):
                s_rows = ref.top(q_unit, gallery, K)[1]
        search_gap = float(ref.gaps(q_unit, gallery, s_rows).max())
        expanded = ref.qge1_query(s_rows, gallery, k_qe, w_qe)
        served = [replies[i].ids for i in ok]
        if control:
            with ref.precision(True):
                expanded_c = ref.qge1_query(s_rows, gallery, k_qe, w_qe)
                served = ref.top(expanded_c, gallery, K)[1].tolist()
        sample = rng(st.seed, "served.check").permutation(len(ok))[:tr["check_sample"]]
        rerank_gap, near = _match(ref, expanded, gallery, served, K,
                                  [int(x) for x in sample], float(tr["limits"]["rank_gap"]))
        desc_gap = 0.0
        for s in sample:
            i = ok[int(s)]
            canvas, hw = ref.decode_canvas(st.pool.jpegs[int(out["choices"][i])],
                                           cfg["image_size"])
            v_ref = ref.descriptor(st.sd, canvas, hw, cfg, dev)
            if control:
                with ref.precision(True):
                    v_got = ref.descriptor(st.sd, canvas, hw, cfg, dev)[None]
            else:
                v_got = q_unit[near[int(s)]]
            desc_gap = max(desc_gap, float((v_got - v_ref).norm(dim=1).min()))
    return {"desc_gap": desc_gap, "rank_gap": max(search_gap, rerank_gap),
            "search_gap": search_gap, "rerank_gap": rerank_gap}


def _match(ref, expanded, gallery, served, K, sample, tol, block=64):
    """Each answer against every recorded row's reference qge1 scores.
    Answers carry no row, so an answer's gap is its smallest over the rows;
    for the ``sample`` answers, the rows within ``tol`` of that smallest
    gap are returned too (rows whose lists equal the answer's), whose
    descriptors the caller holds against the upload's."""
    best, _ = ref.top(expanded, gallery, K)                              # (R, K)
    worst, near = 0.0, {}
    wanted = set(sample)
    for s in range(0, len(served), block):
        ids = served[s:s + block]
        bad = [len(x) != K or len(set(x)) != K or min(x) < 0 or max(x) >= gallery.shape[0]
               for x in ids]
        t = torch.tensor([x if not b else [0] * K for x, b in zip(ids, bad)],
                         device=gallery.device)
        got = torch.einsum("rd,nkd->nrk", expanded, gallery[t])         # (n, R, K)
        gap = (best[None] - got).amax(-1).clamp(min=0.0)                # (n, R)
        g = gap.min(1).values
        for j, b in enumerate(bad):
            worst = math.inf if b else max(worst, float(g[j]))
            if s + j in wanted:
                near[s + j] = torch.nonzero(gap[j] <= g[j] + tol)[:, 0]
    return worst, near


def run(ctx, control: bool = False) -> Outcome:
    """One run; with ``control`` the record also holds the control's
    readings on the same inputs (``calibrate.py``)."""
    st = setup(ctx)
    ctx.setup_done()
    with ctx.window():
        out = drive(st, ctx.traffic["rate_per_s"], ctx.seconds, ctx.seed)
    rec = record(ctx, st, out)
    peak = ctx.memory_peak_bytes()
    close(st)
    st.service = st.front = st.app = None
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    vals = readings(ctx, st, out)
    if control:
        rec["control"] = readings(ctx, st, out, control=True)
    failed = sum(not r.ok for r in out["replies"])
    return Outcome(rec, checks(ctx.traffic, vals), len(out["replies"]), failed, peak)
