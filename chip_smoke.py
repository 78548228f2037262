#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py

Drives ``image_search_engine_for_historical_research_tpu_torch`` on the card:

1. Environment: versions, the card's name and power limit, the kernels'
   build from the sources in this checkout (``nvcc`` for the beam-search
   kernel and its phase-clock build, ``g++`` for the HNSW builder, all started
   together; ``-Xptxas -v`` printed for both kernel builds), TF32 off for
   matmuls and cuDNN.
2. The HNSW beam-search kernel against its plain PyTorch version on the card:
   ragged N=203 x 2048 with -1 padding and repeated ids (ids equal in order);
   the edge cases of ``ops.beam_search_cases`` on quarter-valued data, where
   every distance and tie is exact (duplicate rows, m0 16/32/64/128, ef
   32/100/200/2000, hops with more fresh rows than warps, bf16, N=11, an all
   -1 row, an N that fits only without the neighbour-row cache), ids and
   distances equal in order; then N=1,000,000 x 2048 (f32 and bf16) with a
   random m0=32 neighbour table, Q=70, ef=100, with the phase-clock split at
   f32.
3. A device-built 1M graph: 1,000,000 x 2048 clustered unit rows (8,192
   centres in a 64-d subspace, spread 0.1, bf16) made on the card from a
   seeded generator; ``build_hnsw_device(m=16, k_candidates=64)`` with each
   stage's seconds; structure checks; the exact top-100 of 70 gallery rows
   (``FlatIndex``, with the flat scan's time and byte bound); recall@10 >=
   0.95 through the kernel route and the lockstep route (``use_kernel=False``);
   the kernel against its plain version on that graph (same id sets), timed.
4. The main path through the entry points a user calls: 16 synthetic JPEGs
   through ``cli.offline --matching-method L2`` (ResNet101-SOLAR at full
   width, seeded, perturbed weights carried in as Flax-layout numpy arrays
   through ``from_flax_variables`` and saved as a SOLAR checkpoint; 1024 px,
   three scales) into the feature store; 4,096 clustered descriptors as a
   second store; ``cli.offline --ifextracted --matching-method HNSW
   --ifgenerate`` over both (the native host build, m=16, ef=100, and its
   probe query through the kernel); ``cli.online.make_service``; 4 WSGI
   POSTs, the same 4 images and 4 more through ``query_image``, and one
   ``query_batch`` of 4. The kernel's launch count is set to 0 just before
   each path and read just after; every HNSW search must have launched it.
   One query on a CPU-built service must give the card's ids. Then an
   ``--matching-method L2`` service on the card, whose rank 0 must equal the
   HNSW service's for the 4 POSTs, and a CPU-built L2 service with the card's
   L2 ids for one query.
5. Kernel and plain times at the served shapes (Q=1 and Q=32, ids equal in
   order), and the phase-clock split at Q=1.

Kernel times are medians of CUDA events around one call with the L2 flushed
before it (``ms``), and the same with a spin kernel queued ahead of the first
event, so the host's launch gaps are hidden (``device_ms``).

Prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it does so too without a
CUDA device.
"""

import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_BIG, D, M0, Q_BIG, EF = 1_000_000, 2048, 32, 70, 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def compare_beams(s_ref, i_ref, s_got, i_got, atol, tie=None):
    """Same id set per row, same distance per id (``atol``), and where the
    order differs the distances at those ranks within ``tie``; ``tie=None``
    asks for the ids in the same order. Returns the largest distance
    difference."""
    s_ref, i_ref, s_got, i_got = (t.cpu().numpy() for t in (s_ref, i_ref, s_got, i_got))
    err = 0.0
    for r in range(i_ref.shape[0]):
        check(sorted(i_ref[r].tolist()) == sorted(i_got[r].tolist()),
              f"beam row {r}: kernel and plain id sets differ")
        ref = dict(zip(i_ref[r].tolist(), s_ref[r].tolist()))
        for i, s in zip(i_got[r].tolist(), s_got[r].tolist()):
            err = max(err, abs(ref[i] - s))
        moved = i_ref[r] != i_got[r]
        if moved.any():
            check(tie is not None, f"beam row {r}: ids differ in order")
            check(np.abs(s_ref[r][moved] - s_got[r][moved]).max() <= tie,
                  f"beam row {r}: order differs beyond ties")
    check(err <= atol, f"kernel vs plain distance error {err} > {atol}")
    return err


SLEEP_CYCLES = 2_000_000     # torch.cuda._sleep spin ahead of a timed run


def time_ms(fn, reps, flush, spin=False):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up,
    with the L2 cache flushed before each run (a served query finds it cold).
    With ``spin``, a spin kernel runs before the first event, so the host has
    queued all of ``fn``'s launches before the card reaches them: the time is
    the card's, without the host's launch gaps."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(stats, q, d, elt, ef_pad, m0):
    """Least time for this run's work: every row read once (seeds + fresh
    rows), every neighbour row read once, queries in, beams out; operations
    are q.v and ||v||^2 in f32 for every scored row."""
    rows = stats["seeds"] + stats["fresh_rows"]
    nbytes = rows * d * elt + stats["expansions"] * m0 * 4 + q * d * 4 + q * 4 + q * ef_pad * 8
    ops = rows * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def measure(bs, db, nbr0, q, starts, flush, tie, reps=20, plain_reps=3):
    """Kernel vs plain on one input: error, times, this run's work."""
    s_k, i_k = bs.beam_search(db, nbr0, q, starts, ef=EF)
    torch.cuda.synchronize()
    stats = {}
    s_p, i_p = bs.beam_search_reference(db, nbr0, q, starts, ef=EF, stats=stats)
    err = compare_beams(s_p, i_p, s_k, i_k, atol=1e-3, tie=tie)
    run = lambda: bs.beam_search(db, nbr0, q, starts, ef=EF)  # noqa: E731
    ms = time_ms(run, reps, flush)
    device_ms = time_ms(run, reps, flush, spin=True)
    plain = time_ms(lambda: bs.beam_search_reference(db, nbr0, q, starts, ef=EF),
                    plain_reps, flush)
    elt = db.element_size()
    bnd, by, nbytes = bound_ms(stats, q.shape[0], db.shape[1], elt,
                               bs.padded_ef(EF), nbr0.shape[1])
    hops = stats["expansions"] / q.shape[0]
    rec = {"N": db.shape[0], "D": db.shape[1], "dtype": str(db.dtype).split(".")[-1],
           "Q": q.shape[0], "ef": EF, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain, "bound_ms": bnd,
           "bound_by": by, "bytes": nbytes, "max_abs_err": err,
           "expansions_per_query": hops, "us_per_hop": ms * 1000 / hops,
           "fresh_rows_per_query": stats["fresh_rows"] / q.shape[0]}
    return rec


def sm_cycles_per_us():
    """The SM clock under a spin kernel: cycles of torch.cuda._sleep over its
    CUDA-event time."""
    torch.cuda._sleep(SLEEP_CYCLES)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 * SLEEP_CYCLES)
    b.record()
    torch.cuda.synchronize()
    return 10 * SLEEP_CYCLES / (a.elapsed_time(b) * 1000)


def phase_split(bs, label, db, nbr0, q, starts, flush):
    """Run the phase-clock build once, check its beams against the served
    build's, and print each phase's share of the hop loop and its us per hop
    (cycles converted at the SM clock a spin kernel shows)."""
    run = lambda: bs.beam_search_phase_clocks(db, nbr0, q, starts, ef=EF)  # noqa: E731
    ms = time_ms(run, 5, flush)
    s_c, i_c, clk = run()
    s_k, i_k = bs.beam_search(db, nbr0, q, starts, ef=EF)
    compare_beams(s_k, i_k, s_c, i_c, atol=1e-3, tie=1e-3)
    c = clk.double().cpu()
    named = dict(zip(bs.CLOCK_SLOTS, c.sum(0).tolist()))
    cyc_per_us = sm_cycles_per_us()
    loop = sum(named[k] for k in ("A", "B", "C", "barrier"))
    hops = named["hops"]
    rec = {"phase_clocks": label, "Q": q.shape[0], "ms": ms, "cycles_per_us": cyc_per_us,
           "hops_per_query": hops / q.shape[0],
           "fresh_rows_per_hop": named["fresh_rows"] / hops,
           "same_hop_pop_share": named["same_hop_pops"] / hops,
           "loop_share_of_block": loop / float(c[:, 7].sum()),
           "block_us": float(c[:, 7].max()) / cyc_per_us}
    for k in ("A", "B", "C", "barrier"):
        rec[f"{k}_share"] = named[k] / loop
        rec[f"{k}_us_per_hop"] = named[k] / hops / cyc_per_us
    print(json.dumps(rec), flush=True)
    return rec


def run_case(bs, cases, name, dev):
    """The kernel and its phase-clock build against plain on one edge case:
    ids in order, distances exact. Returns the largest distance difference
    and whether the launch kept the neighbour-row cache."""
    args, kw, ef, dtype = cases.EDGE_CASES[name]
    db, nbr0, q, starts = cases.quarter_case(*args, **kw)
    db = torch.as_tensor(db, device=dev).to(getattr(torch, dtype)).contiguous()
    args = (db,) + tuple(torch.as_tensor(a, device=dev) for a in (nbr0, q, starts))
    cache, _ = bs.shared_memory_plan(*db.shape, nbr0.shape[1], bs.padded_ef(ef))
    check(bool(cache) != (name in cases.NO_CACHE),
          f"edge case {name}: launched {'with' if cache else 'without'} the cache")
    s_k, i_k = bs.beam_search(*args, ef=ef)
    s_c, i_c, _ = bs.beam_search_phase_clocks(*args, ef=ef)
    torch.cuda.synchronize()
    s_p, i_p = bs.beam_search_reference(*args, ef=ef)
    compare_beams(s_p, i_p, s_c, i_c, atol=0.0)
    return compare_beams(s_p, i_p, s_k, i_k, atol=0.0), cache


def random_table(n, m0, g, dev):
    """Random neighbour table with ragged -1 tails and a repeated id per row."""
    nbr = torch.randint(0, n, (n, m0), generator=g, device=dev, dtype=torch.int32)
    tail = torch.randint(0, m0 // 4, (n, 1), generator=g, device=dev)
    nbr[torch.arange(m0, device=dev)[None, :] >= m0 - tail] = -1
    nbr[:, 9] = nbr[:, 2]
    return nbr


def unit_rows(x):
    return x / x.norm(dim=1, keepdim=True)


def kernel_phase(bs, cases, dev, flush):
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    # (a) ragged N with padding and repeats, ids in order
    db = unit_rows(torch.randn(203, D, generator=g, device=dev))
    nbr = random_table(203, M0, g, dev)
    q = unit_rows(torch.randn(8, D, generator=g, device=dev))
    starts = torch.randint(0, 203, (8,), generator=g, device=dev, dtype=torch.int32)
    s_k, i_k = bs.beam_search(db, nbr, q, starts, ef=EF)
    s_p, i_p = bs.beam_search_reference(db, nbr, q, starts, ef=EF)
    out["n203"] = compare_beams(s_p, i_p, s_k, i_k, atol=1e-4)
    print(f"kernel vs plain, N=203 D={D} f32 Q=8: ids in order, max_abs_err {out['n203']}",
          flush=True)
    # (b) the edge cases, exact; the phase-clock build must agree as well
    for name, (args, _, ef, dtype) in cases.EDGE_CASES.items():
        err, cache = run_case(bs, cases, name, dev)
        print(f"edge case {name}: (seed, N, D, m0, Q) {args} ef={ef} {dtype} "
              f"{'with' if cache else 'without'} the neighbour-row cache: "
              f"ids in order, max_abs_err {err}", flush=True)
        out["n203"] = max(out["n203"], err)
    # (c) 1M x 2048, generated on the card
    db = unit_rows(torch.randn(N_BIG, D, generator=g, device=dev))
    nbr = random_table(N_BIG, M0, g, dev)
    pick = torch.randint(0, N_BIG, (Q_BIG,), generator=g, device=dev)
    q = unit_rows(db[pick] + 0.5 * torch.randn(Q_BIG, D, generator=g, device=dev) / D ** 0.5)
    starts = torch.randint(0, N_BIG, (Q_BIG,), generator=g, device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        dbt = db.to(dtype).contiguous()
        rec = measure(bs, dbt, nbr, q, starts, flush, tie=1e-3, plain_reps=3)
        out[f"1m_{rec['dtype']}"] = rec
        print("beam_search at 1M:", json.dumps(rec), flush=True)
        if dtype == torch.float32:
            out["clocks_1m"] = phase_split(bs, "1M f32 Q=70", dbt, nbr, q, starts, flush)
        del dbt
    del db, nbr
    torch.cuda.empty_cache()
    return out


def clustered_rows(n, d, g, dev, n_centers=8192, d_eff=64, spread=0.1, chunk=131072):
    """(n, d) bf16 unit rows near a d_eff-dimensional subspace: centres on the
    d_eff sphere plus ``spread`` noise, embedded by a random (d_eff, d) map
    (the JAX package's ``scripts/synth_data.py`` recipe). Isotropic noise in
    2048 dimensions would make every row nearly orthogonal to every other."""
    centers = unit_rows(torch.randn(n_centers, d_eff, generator=g, device=dev))
    u = torch.randn(d_eff, d, generator=g, device=dev) / d ** 0.5
    out = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        a = torch.randint(0, n_centers, (c,), generator=g, device=dev)
        z = centers[a] + spread * torch.randn(c, d_eff, generator=g, device=dev)
        out[s:s + c] = unit_rows(z @ u).to(torch.bfloat16)
    return out


def coarse_starts(ix, q):
    """The kernel route's entry points: each query's best coarse node by
    inner product (``HNSWIndex.search_kernel``)."""
    coarse = ix.vectors[ix.coarse_ids.long()].float()
    return ix.coarse_ids[torch.topk(q @ coarse.T, 1, dim=1).indices[:, 0]].contiguous()


def recall_at(exact, got, k):
    exact, got = exact[:, :k].cpu().tolist(), got[:, :k].cpu().tolist()
    return float(np.mean([len(set(e) & set(r)) / k for e, r in zip(exact, got)]))


def graph_phase(bs, dev, flush, card):
    """A device-built HNSW graph over 1M x 2048: build, structure, recall of
    both search routes against the exact top-k, the kernel against plain."""
    from image_search_engine_for_historical_research_tpu_torch.index import (
        FlatIndex,
        build_hnsw_device,
    )
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import exact_topk

    g = torch.Generator(device=dev).manual_seed(7)
    db = clustered_rows(N_BIG, D, g, dev)
    # one chunk of the build's candidate pass (8,192 rows against 16,384, k=65):
    # the bf16 GEMM with f32 scores the port uses, its top-k, and the f32
    # upcast the port does not use on the card
    qc, xc = db[:8192], db[:16384]
    chunk_rec = {"knn_chunk": "8192 x 16384 x 2048 bf16",
                 "mm_out_f32_ms": time_ms(lambda: torch.mm(qc, xc.T, out_dtype=torch.float32),
                                          10, flush),
                 "upcast_f32_mm_ms": time_ms(lambda: qc.float() @ xc.float().T, 10, flush)}
    s = torch.mm(qc, xc.T, out_dtype=torch.float32)
    chunk_rec["topk65_ms"] = time_ms(lambda: torch.topk(s, 65, dim=1), 10, flush)
    print("candidate pass, one chunk:", json.dumps(chunk_rec), f"({card})", flush=True)
    del qc, xc, s
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"device graph build, {N_BIG} x {D} bf16, m=16, k_candidates=64 ({card}):",
          flush=True)
    t0 = time.perf_counter()
    ix = build_hnsw_device(db, m=16, normalize=False, k_candidates=64, verbose=True,
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"device graph build_s {build_s} ({card}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del db
    nbr, n = ix.nbr0, ix.n
    check(tuple(nbr.shape) == (N_BIG, M0), f"nbr0 shape {tuple(nbr.shape)}")
    check(bool(((nbr >= -1) & (nbr < n)).all()), "nbr0 holds an invalid id")
    rows = torch.arange(n, device=dev)[:, None]
    check(not bool(((nbr == rows) & (nbr >= 0)).any()), "nbr0 holds a self-loop")
    degree = (nbr >= 0).sum(1)
    check(int(degree.min()) >= 1, "a node without neighbours")
    print(f"structure: no self-loops, ids valid, neighbours a row min {int(degree.min())} "
          f"mean {float(degree.float().mean())}, coarse nodes {ix.coarse_ids.shape[0]}",
          flush=True)

    q = ix.vectors[:Q_BIG].float().contiguous()
    flat = FlatIndex(vectors=ix.vectors, storage_dtype="bfloat16")
    _, exact = flat.search(q, 100)
    run = lambda: exact_topk(q, ix.vectors, 100, matmul_dtype=torch.bfloat16)  # noqa: E731
    flat_ms = time_ms(run, 20, flush)
    flat_bytes = ix.vectors.numel() * 2 + q.numel() * 4 + Q_BIG * 100 * 12
    flat_rec = {"exact_topk": "1M bf16", "N": n, "D": D, "Q": Q_BIG, "k": 100, "ms": flat_ms,
                "bound_ms": flat_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "flops": 2 * Q_BIG * n * D, "mm_out_dtype": "torch.mm(out_dtype=float32)"}
    print("flat scan:", json.dumps(flat_rec), f"({card})", flush=True)

    bs.launches = 0
    _, ids_k = ix.search(q, 10, ef=EF)
    torch.cuda.synchronize()
    launches = bs.launches
    check(launches == 1, f"1M kernel route launched the kernel {launches} times, want 1")
    t0 = time.perf_counter()
    _, ids_l = ix.search(q, 10, ef=EF, use_kernel=False)
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    r_k, r_l = recall_at(exact, ids_k, 10), recall_at(exact, ids_l, 10)
    print(f"recall@10 at ef={EF}: kernel route {r_k}, lockstep route {r_l} "
          f"(lockstep search_s {lock_s})", flush=True)
    check(r_k >= 0.95, f"kernel route recall@10 {r_k} < 0.95")
    check(r_l >= 0.95, f"lockstep route recall@10 {r_l} < 0.95")

    rec = measure(bs, ix.vectors, ix.nbr0, q, coarse_starts(ix, q), flush, tie=1e-3)
    rec.update(graph="device-built", launches=launches, recall10_kernel=r_k,
               recall10_lockstep=r_l, build_s=build_s,
               fresh_rows_per_hop=rec["fresh_rows_per_query"] / rec["expansions_per_query"])
    print("beam_search on the device-built 1M graph:", json.dumps(rec), f"({card})", flush=True)
    del ix, flat, q, exact
    torch.cuda.empty_cache()
    return rec


def write_images(directory, n, rng):
    """JPEGs larger than 1024 px: a two-colour grating of random frequency
    and angle, a few flat blocks and noise, so descriptors differ clearly."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = [(960, 1280), (1280, 960), (1400, 1100)][i % 3]
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        th, f = rng.uniform(0, np.pi), rng.uniform(3, 40)
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th)))[..., None]
        arr = rng.uniform(0, 255, 3) * wave + rng.uniform(0, 255, 3) * (1 - wave)
        for _ in range(rng.integers(1, 6)):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            arr[y0:y0 + rng.integers(h // 8, h // 2),
                x0:x0 + rng.integers(w // 8, w // 2)] = rng.uniform(0, 255, 3)
        arr += rng.normal(0, 10, arr.shape)
        p = os.path.join(directory, f"img{i:02d}.jpg")
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths


def perturb_flax(tree, rng):
    """Seeded noise on every Flax-layout parameter and BN statistic (small on
    BN: larger shifts through 33 blocks make all descriptors nearly equal)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_flax(v, rng)
            continue
        n = rng.standard_normal(v.shape)
        if k == "kernel":
            v = v + 0.5 * n / np.sqrt(np.prod(v.shape[:-1]))
        elif k == "var":
            v = v * np.exp(0.04 * n)
        elif k == "gem_p":
            v = v + 0.25 * np.abs(n)
        else:
            v = v + 0.02 * n
        out[k] = np.asarray(v, np.float32)
    return out


def post(app, path):
    with open(path, "rb") as f:
        payload = f.read()
    status = {}
    body = b"".join(app(
        {"REQUEST_METHOD": "POST", "CONTENT_TYPE": "image/jpeg",
         "CONTENT_LENGTH": str(len(payload)), "wsgi.input": io.BytesIO(payload),
         "HTTP_ACCEPT": "application/json"},
        lambda s, h: status.setdefault("s", s),
    ))
    check(status["s"] == "200 OK", f"POST {path}: {status['s']}")
    return json.loads(body)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    from image_search_engine_for_historical_research_tpu_torch import native
    from image_search_engine_for_historical_research_tpu_torch.cli import offline, online
    from image_search_engine_for_historical_research_tpu_torch.data import (
        load_path_features,
        save_path_feature,
    )
    from image_search_engine_for_historical_research_tpu_torch.models import (
        from_flax_variables,
        init_network,
        to_flax_variables,
    )
    from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
    from image_search_engine_for_historical_research_tpu_torch.ops import beam_search_cases
    from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card}", flush=True)

    # 1. build every kernel and native library, all compilers started together
    t0 = time.perf_counter()
    libs = ("beam_search", "beam_search_clocks", "hnsw")
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for f in [pool.submit(native.load, name) for name in libs]:
            f.result()
    print(f"build_s {time.perf_counter() - t0:.2f}")
    for name in libs[:2]:
        log = native.build_log(name)
        print(f"nvcc -Xptxas -v, {name}:\n{log.strip()}")
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        check(spills and not any(int(n) for n in spills), f"{name}: ptxas reports spills")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    # 2. kernel against plain on the card
    kres = kernel_phase(bs, beam_search_cases, dev, flush)

    # 3. a device-built HNSW graph at 1M
    graph_rec = graph_phase(bs, dev, flush, card)

    # 4. the main path through the entry points
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "data")
        outputs = os.path.join(tmp, "outputs")
        paths = write_images(os.path.join(data_root, "images"), 16, rng)

        base = init_network(seed=0, device="cpu")            # ResNet101-SOLAR, full width
        flax_vars = perturb_flax(to_flax_variables(base.module.state_dict()), rng)
        ckpt = os.path.join(tmp, "resnet101-solar-smoke.pth")
        torch.save({"state_dict": from_flax_variables(flax_vars), "meta": base.meta}, ckpt)
        del base

        common = ["--outputs", outputs, "--data-root", data_root, "--network-path", ckpt,
                  "--device", "cuda"]

        def offline_run(label, argv):
            """One ``cli.offline`` run with the kernel's launches counted."""
            bs.launches = 0
            t0 = time.perf_counter()
            check(offline.main(argv + common) == 0, f"cli.offline {label} failed")
            torch.cuda.synchronize()
            print(f"cli.offline {label}: {time.perf_counter() - t0} s, beam kernel "
                  f"launches {bs.launches} ({card})", flush=True)
            return bs.launches

        check(offline_run("L2, extract 16 images", [
            "--datasets", "images", "--matching-method", "L2", "--batch-size", "4"]) == 0,
            "the L2 route launched the beam kernel")
        real, rel = load_path_features("images", root=outputs)
        check(real.shape == (16, 2048) and np.isfinite(real).all(), "bad descriptors")
        check(rel == [f"images/img{i:02d}.jpg" for i in range(16)], f"stored paths {rel}")
        np.testing.assert_allclose(np.linalg.norm(real, axis=1), 1.0, atol=1e-4)

        centers = rng.standard_normal((64, 2048))
        synth = centers[rng.integers(0, 64, 4096)] + 0.6 * rng.standard_normal((4096, 2048))
        synth /= np.linalg.norm(synth, axis=1, keepdims=True)
        save_path_feature("synthetic", synth.astype(np.float32),
                          [f"synthetic/{i:05d}" for i in range(4096)], root=outputs)
        check(offline_run("HNSW over images,synthetic (host build, m=16, ef=100)", [
            "--datasets", "images,synthetic", "--ifextracted", "--matching-method", "HNSW",
            "--ifgenerate"]) == 2, "the HNSW probe (warm-up + timed query) did not "
                                   "launch the beam kernel twice")
        gallery = np.concatenate([real, synth]).astype(np.float32)

        argv = ["--datasets", "images,synthetic", "--outputs", outputs, "--data-root", data_root,
                "--matching-method", "HNSW", "--network-path", ckpt, "--K", "10"]
        svc = online.make_service(online.build_parser().parse_args(argv + ["--device", "cuda"]))
        app = make_wsgi_app(svc)
        post(app, paths[15])                                 # warm-up, outside the count

        bs.launches = 0
        posted = [post(app, p) for p in paths[:4]]
        singles = [svc.query_image(p) for p in paths[4:8]]
        batch = svc.query_batch(paths[4:8])
        torch.cuda.synchronize()
        launches = bs.launches
        check(launches == 4 + 4 + 1, f"beam kernel launched {launches} times, want 9")

        for i, out in enumerate(posted):
            ids = [r["id"] for r in out["results"]]
            check(len(ids) == 10 and ids[0] == i, f"POST image {i}: top ids {ids}")
            t = out["timing"]
            print(f"POST img{i:02d}: extract_s {t['extract_s']:.4f} search_s "
                  f"{t['search_s']:.4f} rerank_s {t['rerank_s']:.4f} ({card})")
        for (r_single, _), (r_batch, t) in zip(singles, batch):
            check([r["id"] for r in r_single] == [r["id"] for r in r_batch],
                  "query_batch differs from query_image")
        for i, (res, _) in enumerate(singles, 4):
            check(res[0]["id"] == i, f"query_image {i}: rank 0 is {res[0]['id']}")
        t = batch[0][1]
        print(f"query_batch B=4: prepare_s {t['prepare_s']:.4f} extract_s {t['extract_s']:.4f} "
              f"search_s {t['search_s']:.4f} rerank_s {t['rerank_s']:.4f} ({card})", flush=True)

        cpu = online.make_service(online.build_parser().parse_args(argv + ["--device", "cpu"]))
        t0 = time.perf_counter()
        cpu_res, _ = cpu.query_image(paths[0])
        cpu_ids = [r["id"] for r in cpu_res]
        gpu_ids = [r["id"] for r in posted[0]["results"]]
        print(f"cpu query_image s {time.perf_counter() - t0:.1f}: ids {cpu_ids} gpu ids {gpu_ids}")
        check(cpu_ids == gpu_ids, "CPU and GPU services disagree")
        cpu.close()

        # the exact route: --matching-method L2 over the same stores
        argv_l2 = [("L2" if a == "HNSW" else a) for a in argv]
        parse = online.build_parser().parse_args
        svc_l2 = online.make_service(parse(argv_l2 + ["--device", "cuda"]))
        app_l2 = make_wsgi_app(svc_l2)
        post(app_l2, paths[15])
        bs.launches = 0
        posted_l2 = [post(app_l2, p) for p in paths[:4]]
        torch.cuda.synchronize()
        check(bs.launches == 0, "the L2 service launched the beam kernel")
        for i, (h, e) in enumerate(zip(posted, posted_l2)):
            h_ids, e_ids = [r["id"] for r in h["results"]], [r["id"] for r in e["results"]]
            t = e["timing"]
            print(f"POST img{i:02d} HNSW top-10 {h_ids} L2 top-10 {e_ids} overlap "
                  f"{len(set(h_ids) & set(e_ids))}/10; L2 extract_s {t['extract_s']:.4f} "
                  f"search_s {t['search_s']:.4f} rerank_s {t['rerank_s']:.4f} ({card})")
            check(e_ids[0] == h_ids[0] == i, f"POST image {i}: L2 rank 0 {e_ids[0]}, "
                                             f"HNSW rank 0 {h_ids[0]}")
        cpu_l2 = online.make_service(parse(argv_l2 + ["--device", "cpu"]))
        cpu_l2_ids = [r["id"] for r in cpu_l2.query_image(paths[1])[0]]
        gpu_l2_ids = [r["id"] for r in posted_l2[1]["results"]]
        print(f"L2 cpu ids {cpu_l2_ids} gpu ids {gpu_l2_ids}", flush=True)
        check(cpu_l2_ids == gpu_l2_ids, "CPU and GPU L2 services disagree")
        cpu_l2.close()
        svc_l2.close()

        # 5. the kernel at the served shapes: Q=1 (a POST) and Q=32 (the largest slot)
        qv = torch.as_tensor(gallery[:32], device=dev)
        qv = unit_rows(qv + 0.02 * torch.randn(qv.shape, device=dev,
                                               generator=torch.Generator(device=dev).manual_seed(1)))
        idx = svc.index
        starts = coarse_starts(idx, qv)
        served = []
        for q in (1, 32):
            rec = measure(bs, idx.vectors, idx.nbr0, qv[:q].contiguous(),
                          starts[:q].contiguous(), flush, tie=None)
            served.append(rec)
            print("beam_search served:", json.dumps(rec), flush=True)
        phase_split(bs, "served Q=1", idx.vectors, idx.nbr0, qv[:1].contiguous(),
                    starts[:1].contiguous(), flush)
        svc.close()

    err = max([kres["n203"], kres["1m_float32"]["max_abs_err"],
               kres["1m_bfloat16"]["max_abs_err"], graph_rec["max_abs_err"]]
              + [r["max_abs_err"] for r in served])
    main_rec = served[0]
    print(json.dumps({"kernels": [{
        "name": "beam_search",
        "route": "cuda",
        "source": "image_search_engine_for_historical_research_tpu_torch/csrc/beam_search.cu",
        "replaces": "image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:354",
        "launches": launches,
        "max_abs_err": err,
        "ms": main_rec["ms"],
        "device_ms": main_rec["device_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
        "us_per_hop": main_rec["us_per_hop"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
