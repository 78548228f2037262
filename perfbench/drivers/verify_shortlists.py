"""A closed loop of shortlist verifications: each request re-ranks one
query's top-``b`` candidates by LoFTR match counts, as ``cli.test_reranking
--methods loftr`` does (``rerank.loftr_rerank`` with the count driver of
``models.loftr`` the configuration names), one request after another.

The photographs are a seeded pool of scene photographs on disk, which
``loftr_rerank`` reads and resizes itself; each request's candidates are
drawn from the seed over the pool, the other views of the query's own scene
among them, in a seeded order. A fixed number of distinct requests is
cycled.

Checked after the window on a seeded sample of the requests run: every
pair's count (the count driver's outputs, recorded by a wrapper that keeps
references only) against the plain reference's count of the same two
files, and the re-ranked order against the reference's stable re-sort of
the program's own counts (the re-rank stage, exact).
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.harness import photos
from perfbench.harness.core import Outcome, apply_precision, checks
from perfbench.harness.seeds import rng


def requests(seed: int, n: int, scenes: np.ndarray, b: int, same: int) -> List[tuple]:
    """``n`` (query, candidates) pairs of pool indices: ``same`` other views
    of the query's scene and ``b - same`` photographs of other scenes, in
    a seeded order."""
    r = rng(seed, "verify.requests")
    out = []
    for q in r.choice(len(scenes), size=n, replace=False):
        own = np.flatnonzero((scenes == scenes[q]) & (np.arange(len(scenes)) != q))
        other = np.flatnonzero(scenes != scenes[q])
        cand = np.concatenate([r.choice(own, size=min(same, len(own)), replace=False),
                               r.choice(other, size=b - min(same, len(own)), replace=False)])
        out.append((int(q), r.permutation(cand)))
    return out


@dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: str
    sd: dict
    count_fn: Any
    log: list
    paths: List[str]
    requests: List[tuple]
    tmp: Any


def _count_fn(cfg: dict, matcher):
    from image_search_engine_for_historical_research_tpu_torch.models import loftr

    return {"batched": loftr.make_batched_count_fn}[cfg["count_driver"]](matcher)


def setup(ctx) -> State:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    apply_precision(cfg)
    system = ctx.system()
    pool = photos.make_pool(ctx.seed, tr["pool"], tr["scenes"], tr["sizes_hw"],
                            tr["jpeg_quality"], dev)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-verify-")
    paths = photos.write_pool(pool.jpegs, tmp.name)
    ref = ctx.reference()
    w, h = cfg["resolution_wh"]
    calib = torch.stack([torch.as_tensor(ref.load_grey(p, w, h), device=dev)
                         for p in paths[:tr["calibration_photos"]]])[:, None]
    sd = system.state_dict(cfg, ctx.seed, dev, calibration=calib,
                           features=ref.layer3_features)
    inner = _count_fn(cfg, system.build_matcher(cfg, sd, dev))
    log: list = []

    def count_fn(imgs0, imgs1):
        out = inner(imgs0, imgs1)
        log.append(out)
        return out

    reqs = requests(ctx.seed, tr["distinct_requests"], pool.scene, tr["b"], tr["same_scene"])
    st = State(cfg, tr, ctx.seed, dev, sd, count_fn, log, paths, reqs, tmp)
    q, cand = reqs[0]
    for _ in range(2):
        verify(st, q, cand[:cfg["pair_batch"]])
    ctx.sync()
    log.clear()
    return st


def verify(st: State, q: int, cand: np.ndarray) -> np.ndarray:
    from image_search_engine_for_historical_research_tpu_torch.rerank.geometric import (
        loftr_rerank,
    )

    return loftr_rerank([st.paths[q]], st.paths, np.asarray(cand)[None], count_fn=st.count_fn,
                        b=len(cand), resolution=tuple(st.cfg["resolution_wh"]),
                        pair_batch=st.cfg["pair_batch"])[0]


def drive(st: State, seconds: float) -> Dict[str, Any]:
    done: List[tuple] = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        q, cand = st.requests[i % len(st.requests)]
        start = len(st.log)
        order = verify(st, q, cand)
        done.append((i % len(st.requests), start, len(st.log), order))
        i += 1
    return {"done": done, "window_s": time.perf_counter() - t0}


def record(ctx, st: State, out: Dict[str, Any]) -> Dict[str, Any]:
    w, h = st.cfg["resolution_wh"]
    pairs = sum(len(st.requests[r][1]) for r, _, _, _ in out["done"])
    return {
        "setup_s": ctx.setup_s,
        "window_s": out["window_s"],
        "pairs_done": pairs,
        "blocks_run": sum(e - s for _, s, e, _ in out["done"]),
        "block_flops": ctx.flops().block_flops(st.cfg["pair_batch"], h, w, st.cfg["matcher"]),
        "trace": ctx.trace_summary,
    }


def readings(ctx, st: State, out: Dict[str, Any], control: bool = False) -> Dict[str, float]:
    """``count_gap``: the summed |program - reference| count over the
    sampled requests' pairs. ``order_mismatch``: the places at which the
    re-ranked order differs from the reference's stable re-sort of the
    program's own counts (the re-rank stage from the program's state; an
    exact comparison). With ``control`` the reference in TF32 stands in
    the program's place."""
    ref = ctx.reference()
    done = out["done"]
    pick = rng(st.seed, "verify.check").permutation(len(done))[:st.traffic["check_requests"]]
    count_gap, order_mismatch = 0, 0
    with ref.precision(False):
        for j in pick:
            r, s, e, order = done[int(j)]
            q, cand = st.requests[r]
            paths = [st.paths[c] for c in cand]
            want = ref.pair_counts(st.sd, st.paths[q], paths, st.cfg, st.device)
            if control:
                with ref.precision(True):
                    got = ref.pair_counts(st.sd, st.paths[q], paths, st.cfg, st.device)
                order = ref.reranked(cand, got)
            else:
                got = torch.cat(st.log[s:e]).cpu().numpy().astype(np.int64)[:len(cand)]
            count_gap += int(np.abs(got - want).sum())
            expect = ref.reranked(cand, got)
            order = np.asarray(order)
            order_mismatch += len(cand) if order.shape != expect.shape else \
                int((order != expect).sum())
    return {"count_gap": count_gap, "order_mismatch": order_mismatch}


def close(st: State) -> None:
    st.tmp.cleanup()


def run(ctx, control: bool = False) -> Outcome:
    """One run; with ``control`` the record also holds the control's
    readings on the same inputs (``calibrate.py``)."""
    st = setup(ctx)
    ctx.setup_done()
    with ctx.window():
        out = drive(st, ctx.seconds)
    rec = record(ctx, st, out)
    peak = ctx.memory_peak_bytes()
    st.count_fn = None
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    vals = readings(ctx, st, out)
    if control:
        rec["control"] = readings(ctx, st, out, control=True)
    close(st)
    return Outcome(rec, checks(ctx.traffic, vals), len(out["done"]), 0, peak)
