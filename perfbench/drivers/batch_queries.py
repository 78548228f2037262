"""A closed loop of query batches ranked against the whole gallery.

The revisited protocol's evaluation, and "find images like this one" from
stored descriptors: each batch goes through the calls that
``SearchService.execute_batch`` makes after extraction,
``FlatIndex.search(q, K)`` with its read-back, then ``rerank.qe.qge1`` over
the shortlist with its read-back, one batch after another. The batches are
drawn from the seed near the gallery's clusters, a fixed number of
distinct ones, cycled.

Checked after the window on a seeded sample of the batches run: each
shortlist against the plain reference's exact top-K of the same query
rows, and each final list against the reference's qge1 of the program's
shortlist (stage by stage: a near-tie inside a shortlist moves qge1's
expanded query, so final lists are compared from the shortlist the
program used).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from perfbench.harness import gallery as gallery_mod
from perfbench.harness.core import Outcome, apply_precision, checks
from perfbench.harness.seeds import rng


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: str
    index: Any
    queries: torch.Tensor        # (batches, Q, D) f32 rows, as stored


def setup(ctx) -> State:
    from image_search_engine_for_historical_research_tpu_torch.index.flat import build_flat

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    apply_precision(cfg)
    gallery = ctx.system().make_gallery(cfg, ctx.seed, dev)
    icfg = cfg["index"]
    index = build_flat(gallery, metric=icfg["metric"], storage_dtype=icfg["storage_dtype"],
                       device=dev)
    del gallery
    nb, q = tr["distinct_batches"], tr["queries_per_batch"]
    queries = gallery_mod.make_queries(ctx.seed, cfg["gallery"], nb * q, tr["query_spread"],
                                       dev).reshape(nb, q, -1)
    st = State(cfg, tr, ctx.seed, dev, index, queries)
    step(st, queries[0])
    step(st, queries[1 % nb])
    ctx.sync()
    return st


def step(st: State, q: torch.Tensor, events=None):
    """One batch: search and read back, qge1 and read back. Returns the
    shortlist, the final lists and the two host-clock seconds."""
    from image_search_engine_for_historical_research_tpu_torch.rerank.qe import qge1

    K, rr = st.traffic["K"], st.cfg["rerank"]
    t0 = time.perf_counter()
    if events is not None:
        events[0].record()
    _, ids = st.index.search(q, K)
    if events is not None:
        events[1].record()
    shortlist = ids.cpu().numpy()
    t1 = time.perf_counter()
    ranks = qge1(torch.as_tensor(shortlist, device=st.device), None, st.index.vectors,
                 k=min(rr["k"], K), w=rr["w"], out_k=min(K, st.index.n))
    final = ranks.cpu().numpy()
    t2 = time.perf_counter()
    return shortlist, final, t1 - t0, t2 - t1


def drive(st: State, seconds: float) -> Dict[str, Any]:
    cuda = st.device.startswith("cuda")
    nb = st.queries.shape[0]
    runs: List[tuple] = []
    search_s, rerank_s, events = [], [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
            if cuda else None
        shortlist, final, ts, tr = step(st, st.queries[i % nb], ev)
        runs.append((i % nb, shortlist, final))
        search_s.append(ts)
        rerank_s.append(tr)
        if ev is not None:
            events.append(ev)
        i += 1
    window = time.perf_counter() - t0
    event_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    return {"runs": runs, "window_s": window, "search_s": search_s, "rerank_s": rerank_s,
            "scan_event_s": event_s}


def readings(ctx, st: State, out: Dict[str, Any], control: bool = False) -> Dict[str, float]:
    """Widest score gaps of a seeded sample of the batches run. With
    ``control`` the reference in TF32 stands in the program's place."""
    ref = ctx.reference()
    cfg, tr, dev = st.cfg, st.traffic, st.device
    K, k_qe, w_qe = tr["K"], cfg["rerank"]["k"], cfg["rerank"]["w"]
    gallery = ref.normalize_rows(ctx.system().make_gallery(cfg, st.seed, dev))
    runs = out["runs"]
    pick = rng(st.seed, "batch.check").permutation(len(runs))[:tr["check_batches"]]
    search_gap = rerank_gap = 0.0
    with ref.precision(False):
        for j in pick:
            b, shortlist, final = runs[int(j)]
            q = ref.unit(st.queries[b])
            shortlist = torch.as_tensor(shortlist, device=dev)
            final = torch.as_tensor(final, device=dev)
            if control:
                with ref.precision(True):
                    shortlist = ref.top(q, gallery, K)[1]
                    final = ref.top(ref.qge1_query(shortlist, gallery, k_qe, w_qe), gallery, K)[1]
            search_gap = max(search_gap, float(ref.gaps(q, gallery, shortlist).max()))
            expanded = ref.qge1_query(shortlist, gallery, k_qe, w_qe)
            rerank_gap = max(rerank_gap, float(ref.gaps(expanded, gallery, final).max()))
    return {"rank_gap": max(search_gap, rerank_gap), "search_gap": search_gap,
            "rerank_gap": rerank_gap}


def record(ctx, st: State, out: Dict[str, Any]) -> Dict[str, Any]:
    q, n, d = st.queries.shape[1], st.index.n, st.queries.shape[2]
    return {
        "setup_s": ctx.setup_s,
        "window_s": out["window_s"],
        "batches_done": len(out["runs"]),
        "queries_done": q * len(out["runs"]),
        "search_s": out["search_s"],
        "rerank_s": out["rerank_s"],
        "scan_event_s": out["scan_event_s"],
        "scan_flops_bytes": ctx.flops().scan_flops_bytes(q, n, d, st.traffic["K"]),
        "trace": ctx.trace_summary,
    }


def run(ctx, control: bool = False) -> Outcome:
    """One run; with ``control`` the record also holds the control's
    readings on the same inputs (``calibrate.py``)."""
    st = setup(ctx)
    ctx.setup_done()
    with ctx.window():
        out = drive(st, ctx.seconds)
    rec = record(ctx, st, out)
    peak = ctx.memory_peak_bytes()
    st.index = None
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    vals = readings(ctx, st, out)
    if control:
        rec["control"] = readings(ctx, st, out, control=True)
    n = len(out["runs"]) * st.queries.shape[1]
    return Outcome(rec, checks(ctx.traffic, vals), n, 0, peak)

