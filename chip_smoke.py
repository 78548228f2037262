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
   Then diffusion beyond the reference regime on the first 500,000 of those
   rows: ``build_diffusion_offline(kd=50, batch=1024, allow_large=True,
   memory_budget_bytes=1.5 GiB, host_out=False, score_dtype=float16)`` (T=512,
   the recompute solver) with the kNN-graph and sweep seconds and the peak
   memory; 64 sampled rows solved again by the tables solver over the same
   kNN graph (at least 61 within 1e-3 of the row's largest score); the
   online pass for 70 queries, timed. Then the PQ family on the same rows
   (f32 in the builders): ``build_pq(M=16, Ks=8192)``, ``build_hnsw_pq(M=16,
   Ks=8192, m=16, opq="refine", refine_M=32)`` (the device graph builder)
   and ``build_ivfpq(nlist=316, M=16, Ks=256, nprobe=64, refine_M=32)``, each
   build's stage seconds and peak memory; recall@10 and @100 against the
   exact top-100 and ms at Q=70 and Q=1 of ``adc`` and ``adc+refine`` of
   each and ``graph+refine`` (ef=320, 32 seeds, with and without the
   centroid walk); each route's ids for 8 queries held against the same
   artifact loaded and searched on the CPU (equal but at ties, 1e-5
   relative); ``adc+refine`` recall@100 at least ``adc``'s; the device ops
   (ADC scan, IVF probe, both refine re-ranks, both PQ walks, the encode
   pass) timed beside their bounds, and the host expansion timed alone.
   Then at 65,536 of the rows: two builds of ``build_pq`` and of
   ``build_ivfpq`` from one seed give identical arrays, and a streaming
   ``build_pq`` from device-tensor chunks equals the in-memory build.
4. The global re-rankers at rParis6k's shape: 6,322 x 2048 clustered unit
   rows (11 landmarks among 200 other clusters) and 70 queries, f32, made on
   the card, with a revisited gnd. alphaQE (k=10, 3 iterations) then
   ``diffusion_rerank(n_trunc=2000, kd=200)`` (tables solver; build seconds,
   online ms); AQE, DBA and ``kr_rerank`` (dense, 6,392 rows): each held
   against a CPU run on the same inputs (diffusion's CPU run solves the
   rows the online pass reads), top-100 ranks equal but at ties (ids that
   differ score within 1e-5 of each other, relative, by the CPU's scores);
   ``kr_rerank_chunked`` against the dense path on the card, the same way.
   Then ``kr_rerank`` at 100,000 gallery rows + 70 queries (the chunked path:
   seconds, peak memory, whether the full-width re-run fired).
5. The main path through the entry points a user calls: 16 synthetic JPEGs
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
   L2 ids for one query. Then ``SearchService(rerank="diffusion")`` over the
   HNSW gallery with a card-built artifact (n_trunc=2000, kd=50): 4 POSTs, 4
   ``query_image``, one ``query_batch`` of 4 (the batch's ids equal the
   singles', one kernel launch a search), a CPU-built diffusion service and
   the same artifact loaded on the host give the card's ids. Then 16 POSTs
   from 8 threads through ``CoalescingService(max_batch=8)``: each request's
   ids equal ``query_image``'s, fewer batches than requests, one launch a
   batch. Before that, the PQ family served: ``cli.offline --ifextracted
   --ifgenerate`` with ``HNSW_NanoPQ --opq refine --refine-m 32`` (its
   refine OPQ fit's seconds printed), ``IVFPQ --refine-m 32`` and ``PQ``
   over both stores, each served by ``cli.online.make_service``: 4 WSGI
   POSTs and a ``query_batch`` of the same 4 (equal ids), one query on a
   CPU service from the same artifact (its search equal to the card's but
   at ties, 1e-5 relative; its served ids equal where the searches are),
   the PQ ops' calls
   counted on the served path. Then the remaining matchers (``L2_int8``,
   ``fractional``, ``LSH``, ``ANNOY``, ``Greedyhash``) through ``cli.offline
   --loader pil`` over both stores, and ``cli.online --matching-method
   ANNOY``: 4 WSGI POSTs whose ids equal a CPU-built service's. Then a
   regional (Rpool over GeM) and an R-MAC ResNet101-SOLAR at full width
   extract the 16 JPEGs one image at a time; 2 are held against the CPU at
   1e-4.
   Then the remaining matchers on the same 1M rows: ``build_rpforest(
   n_trees=100, leaf_size=512)``, ``build_flat_i8`` with and without its
   bf16 re-rank copy, LSH codes at 512 bits, Greedyhash-style codes (the
   signs of a seeded projection to 512 bits), PQ_Net over ``pq_train``
   codewords (M=16, Ks=256) and PQ_Net_bucket (10 buckets), and the
   fractional distance on the first 100,000 rows: build seconds and peak
   memory, recall@10/@100 against the exact top-100, ms at Q=70 and Q=1
   beside each search's bound, a ``trace_op`` trace, and 8 queries' ids
   against a CPU run of the same arrays (equal but at ties). Then HNSW
   above the largest N whose visited bitset fits in shared memory: a random
   1,787,777-row bf16 table searched through ``HNSWIndex.search`` (one
   launch, the bitset in device memory), the kernel held against its plain
   version at Q=70 and timed beside one row fewer (bitset in shared
   memory).
6. The CLIs on stored features: phase 4's rows and gnd as a ``rparis6k``
   feature store and gnd pickle; ``cli.benchmark --ifextracted --qge``
   (alphaQE + diffusion), ``cli.test_reranking --methods
   qge,aqe,dba,kr,diffusion``; ``cli.test_custom --save-ranks --html-sheet``
   and ``cli.retrieve --mode custom`` on the 16 JPEGs in label folders.
7. Kernel and plain times at the served shapes (Q=1 and Q=32, ids equal in
   order), and the phase-clock split at Q=1.
8. Offline extraction at scale and training (no beam-kernel path; the
   kernel's count must stay 0): ``cli.extract_1m`` at full width over 256
   synthetic 768 x 1024 JPEGs in a revisitop1m layout (``make_revisitop``,
   the port's ``data.synthetic``): sharded with ``--limit`` at half, then
   resumed at ``shard_resume_point``; one-shot; ``--bf16`` on the first
   half; the resumed shards equal the one-shot rows (1e-4), bf16 keeps a
   mean cosine >= 0.999, and ``build_pq(M=16, Ks=256)`` streamed from
   ``chunked_feature_source`` equals the in-memory build. Decoding is PIL:
   the card's machine has no libjpeg, so the native loader is not driven.
   Then training from the served checkpoint (contrastive + SOS at lambda
   10, AdamW lr 1e-6 wd 1e-6, 7-image tuples at 362 px): one frozen step on
   the card against the CPU (f64: loss and every gradient; f32: the loss),
   ``conv1``-``conv4_x`` without gradients; the ladder of
   ``scripts/measure_train_kr.py`` (unfrozen, frozen, + bf16, + remat, at 10
   tuples) with s/step (median of 10 CUDA-event steps after 2 warm-ups),
   img/s, peak memory, FLOPs a step (``FlopCounterMode``) and ``mfu``
   against 67 TFLOP/s f32 or 989 TFLOP/s bf16; remat's loss and gradients
   against the step without it (rtol 1e-5, no higher peak); ``cli.train``
   for 2 epochs with a held-out eval set, and stopped after epoch 0 and
   resumed, under deterministic cuDNN (epoch-1 step losses equal at rtol
   1e-4); one POST served from the trained checkpoint.
9. SAHA geometric verification (``saha_phase``): the extraction phase's 256
   photographs laid out as a revisited dataset (32 queries, one view a
   scene; 224 views as the database, revisitop1m's gallery cut to them) with
   its one-shot ResNet101-SOLAR rows as the feature stores;
   ``cli.test_reranking --methods sift --sift-backend device
   --matching-method HNSW`` at the JAX defaults (1000 x 1000, 1,024
   keypoints, 4 octaves, AdaLAM's default config, b=30, pair_batch=8),
   K1's launches counted, SIFT img/s and peak memory, AdaLAM pairs/s, the
   re-rank's seconds, mAP E/M/H before and after (printed; held to the JAX
   package's, not to the baseline, see ``saha_phase``); the shortlist's
   verified-match counts against the JAX package's on the same photographs
   and pairs (``scripts/saha_jax_reference.json``: at most 2% of the pairs
   differ, each by at most 1 or 10%; the mAPs within 0.005); the device SIFT of 8 images on the card against
   the CPU (>= 99% of the keypoints within 1e-2 px, descriptors within
   1e-3) and AdaLAM counts of 4 queries x 30 candidates from the same
   features on both (at most 2% of the pairs differ, by at most 1) and per
   pair (equal). Before the PQ phases, the refine OPQ
   fit of ``scripts/measure_torch_opq_fit.py`` split into its parts.
10. LoFTR and D2-Net over the SAHA layout's photographs, with seeded
   random weights (the released checkpoints are not in the repository):
   ``cli.test_reranking --methods loftr --matching-method HNSW
   --loftr-ckpt`` at the default config and the CLI's settings (480 x 640,
   b=60, pair_batch 4: 1,920 pairs; the weights written in the released
   layout), K1's launches counted; 60 named pairs' counts at thr 0.2 and
   0.0 and 2 pairs' confidence row maxima against the JAX package's
   (``scripts/loftr_jax_reference.json``, written on the CPU by
   ``scripts/loftr_jax_witness.py``), 4 pairs against the CPU, the three
   drivers equal, bf16 beside f32, one block of 4 pairs timed alone; the
   LoFTR train step's ladder at 480 x 640 (f32, bf16 + remat, + accum=2)
   and an f64 step at the test config against the CPU; D2-Net's pyramid on
   8 photographs at 768 x 1024, 2 at 384 x 512 against JAX and the CPU,
   and its features through AdaLAM on the card and the CPU. The CPU halves
   run in child processes beside the card's work. (The PQ graph walks'
   route records are timed over 2 + 3 calls, a depth cut for the time
   limit.)

Kernel times are medians of CUDA events around one call with the L2 flushed
before it (``ms``), and the same with a spin kernel queued ahead of the first
event, so the host's launch gaps are hidden (``device_ms``).

Prints a ``{"kernels": [...]}`` line (``launches``: every counted main-path
run: the HNSW and diffusion services, the coalesced batches and the SAHA
and LoFTR runs' HNSW matchers), a
``{"rerank": {...}}`` line with the re-ranking phases' numbers, a
``{"pq": {...}}`` line with the PQ phases' numbers, a ``{"matchers":
{...}}`` line with the remaining matchers' numbers, a ``{"slice7": {...}}``
line with the extraction and training numbers, a ``{"saha": {...}}`` line
with the SAHA phase's, a ``{"slice10": {...}}`` line with the LoFTR and
D2-Net phases', then the ``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failed check raises,
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
import threading
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
    and the launch's plan (the neighbour-row cache, the bitset in shared memory)."""
    args, kw, ef, dtype = cases.EDGE_CASES[name]
    db, nbr0, q, starts = cases.quarter_case(*args, **kw)
    db = torch.as_tensor(db, device=dev).to(getattr(torch, dtype)).contiguous()
    args = (db,) + tuple(torch.as_tensor(a, device=dev) for a in (nbr0, q, starts))
    cache, smem_visited, _ = bs.shared_memory_plan(*db.shape, nbr0.shape[1], bs.padded_ef(ef))
    check(bool(cache) != (name in cases.NO_CACHE),
          f"edge case {name}: launched {'with' if cache else 'without'} the cache")
    check(bool(smem_visited) != (name in cases.DEVICE_VISITED),
          f"edge case {name}: visited bitset {'in' if smem_visited else 'outside'} shared memory")
    s_k, i_k = bs.beam_search(*args, ef=ef)
    s_c, i_c, _ = bs.beam_search_phase_clocks(*args, ef=ef)
    torch.cuda.synchronize()
    s_p, i_p = bs.beam_search_reference(*args, ef=ef)
    compare_beams(s_p, i_p, s_c, i_c, atol=0.0)
    return compare_beams(s_p, i_p, s_k, i_k, atol=0.0), cache, smem_visited


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
        err, cache, smem_visited = run_case(bs, cases, name, dev)
        print(f"edge case {name}: (seed, N, D, m0, Q) {args} ef={ef} {dtype} "
              f"{'with' if cache else 'without'} the neighbour-row cache, visited bitset "
              f"in {'shared' if smem_visited else 'device'} memory: "
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
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import _top_exact

    coarse = ix.vectors[ix.coarse_ids.long()].float()
    return ix.coarse_ids[_top_exact(q @ coarse.T, 1)[1][:, 0]].contiguous()


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
    vectors = ix.vectors
    del ix, flat, q, exact
    torch.cuda.empty_cache()
    return rec, vectors


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


def compare_ranks(ref, got, scores, rtol, label, descending=True):
    """``got`` against the reference ranks ``ref`` (Q, k): where they differ
    at a rank, the id ``got`` put there must score within ``rtol`` (relative)
    of the reference id, by the reference's own ``scores`` (Q, N), i.e. the
    two ids tie at the tolerance. Returns (ranks that differ, largest
    relative gap among them)."""
    ref, got, scores = (torch.as_tensor(x).cpu() for x in (ref, got, scores))
    s_ref, s_got = scores.gather(1, ref.long()), scores.gather(1, got.long())
    moved = ref != got
    gap = ((s_ref - s_got).abs() / s_ref.abs().clamp(min=1e-30))[moved]
    worst = float(gap.max()) if gap.numel() else 0.0
    check(worst <= rtol, f"{label}: ranks differ beyond ties (relative gap {worst} > {rtol})")
    return int(moved.sum()), worst


def revisited_like(dev, n=6322, nq=70, n_land=11, n_other=200, d_eff=64, seed=11):
    """rParis6k's shape: ``n`` x 2048 clustered unit rows (``n_land``
    landmarks among ``n_other`` other clusters, in a ``d_eff``-dimensional
    subspace plus a little full-rank noise) and ``nq`` queries of the
    landmarks, f32, made on the card; and a revisited gnd (each query's
    landmark rows by similarity: first third easy, second hard, rest junk)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = unit_rows(torch.randn(n_land + n_other, d_eff, generator=g, device=dev))
    u = torch.randn(d_eff, D, generator=g, device=dev) / D ** 0.5
    label = torch.randint(0, n_land + n_other, (n,), generator=g, device=dev)
    qlabel = torch.arange(nq, device=dev) % n_land

    def embed(lab):
        z = centers[lab] + 0.18 * torch.randn(lab.shape[0], d_eff, generator=g, device=dev)
        return unit_rows(z @ u + 0.005 * torch.randn(lab.shape[0], D, generator=g, device=dev))

    vecs, qvecs = embed(label), embed(qlabel)
    sims = (qvecs @ vecs.T).cpu().numpy()
    label_h, gnd = label.cpu().numpy(), []
    for i, lab in enumerate(qlabel.tolist()):
        members = np.where(label_h == lab)[0]
        order = members[np.argsort(-sims[i, members], kind="stable")]
        third = max(1, len(order) // 3)
        gnd.append({"easy": order[:third], "hard": order[third:2 * third],
                    "junk": order[2 * third:], "bbx": [0, 0, 10, 10]})
    return vecs.contiguous(), qvecs.contiguous(), gnd


def rerank_phase(dev, flush, card):
    """The global re-rankers at rParis6k's shape, card against CPU: alphaQE
    (k=10, 3 iterations) then diffusion (n_trunc=2000, kd=200, the tables
    solver), AQE, DBA, k-reciprocal dense and chunked."""
    from image_search_engine_for_historical_research_tpu_torch import rerank
    from image_search_engine_for_historical_research_tpu_torch.ops.normalization import l2n
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import (
        exact_ranks,
        exact_scores,
        exact_topk,
    )
    from image_search_engine_for_historical_research_tpu_torch.rerank import diffusion as dif

    vecs, qvecs, gnd = revisited_like(dev)
    vc, qc = vecs.cpu(), qvecs.cpu()
    n, T, kd = vecs.shape[0], 2000, 200
    out = {"n": n, "nq": qvecs.shape[0], "gnd": gnd, "vecs": vecs, "qvecs": qvecs}

    # alphaQE from the exact ranks, on the card and on the CPU
    qe, r_qe = rerank.feature_enhancement(qvecs, vecs, exact_ranks(qvecs, vecs), k=10,
                                          iterations=3)
    qe_c, r_qe_c = rerank.feature_enhancement(qc, vc, exact_ranks(qc, vc), k=10, iterations=3)
    moved, gap = compare_ranks(r_qe_c[:, :100], r_qe[:, :100], exact_scores(qe_c, vc),
                               1e-5, "alphaQE card vs CPU")
    print(f"alphaQE k=10 x3 at {n} x {D}: top-100 card vs CPU, {moved} ranks moved "
          f"(largest relative gap {gap}); max |qe card - qe CPU| "
          f"{float((qe.cpu() - qe_c).abs().max())}", flush=True)

    # diffusion: the offline build and the online pass on the card
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = dif.build_diffusion_offline(vecs, n_trunc=T, kd=kd, stats=st)
    build_s = time.perf_counter() - t0
    check(st["solver"] == "tables" and st["T"] == T, f"6k diffusion build {st}")
    online = lambda: dif.diffusion_rerank(vecs, qe, offline=off, n_trunc=T)[0]  # noqa: E731
    online_ms = time_ms(online, 10, flush)
    r_dfs = online()
    # the CPU run of the same pass on the rows it reads (the card's enhanced
    # queries as input, so only diffusion differs). (a) Over the card's kNN
    # graph and supports: the CG solves, the scatter-add and the top-k on the
    # CPU. (b) Over the CPU's own kNN graph: f32 products on the two devices
    # differ in the last bits and so pick a different kd-th neighbour on a
    # few rows, which moves those rows' scores; reported, and held by the
    # overlap of the top 100.
    qe_h = qe.cpu()
    seeds = torch.unique(exact_topk(qe_h, vc, 3)[1])
    ids_k = off.trunc_ids[seeds.to(dev)].long().cpu()
    sc_k = off.scores[seeds.to(dev)].cpu()
    sims_k, knn_k = dif._knn_graph(vecs, kd)                 # the build's graph
    nbr_k, val_k = (t.cpu() for t in dif._laplacian_from_knn(sims_k, knn_k))

    def cpu_artifact(ids, sc):
        art = dif.DiffusionOffline(torch.zeros((n, T), dtype=torch.int32),
                                   torch.zeros((n, T), dtype=torch.float32))
        art.trunc_ids[seeds], art.scores[seeds] = ids.int(), sc
        return art

    def rel(a, b):
        return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())

    sc_a = dif._batched_trunc_cg(nbr_k, val_k, ids_k)
    sc_err = rel(sc_k, sc_a)
    check(sc_err <= 1e-6, f"6k diffusion: card vs CPU solves over one graph differ by {sc_err}")
    art_a = cpu_artifact(ids_k, sc_a)
    dense_a = dif.diffusion_online_scores(art_a.trunc_ids, art_a.scores, vc, qe_h)
    dense = dif.diffusion_online_scores(off.trunc_ids, off.scores, vecs, qe).cpu()
    dense_err = rel(dense, dense_a)
    check(dense_err <= 1e-5, f"6k diffusion: card vs CPU online scores differ by {dense_err}")
    moved, gap = compare_ranks(dif.diffusion_rerank(vc, qe_h, offline=art_a, n_trunc=T)[0][:, :100],
                               r_dfs[:, :100], dense_a, 1e-5, "diffusion card vs CPU")

    sims_c, knn_c = dif._knn_graph(vc, kd)
    lap_c = dif._laplacian_from_knn(sims_c, knn_c)
    ids_c, sc_c = dif._knn_and_solve(vc[seeds], vc, *lap_c, T)
    row_k = torch.zeros((seeds.numel(), n)).scatter_(1, ids_k, sc_k)     # by gallery id
    row_c = torch.zeros((seeds.numel(), n)).scatter_(1, ids_c, sc_c)
    r_own = dif.diffusion_rerank(vc, qe_h, offline=cpu_artifact(ids_c, sc_c), n_trunc=T)[0]
    overlap = float(np.mean([len(set(a) & set(b)) / 100 for a, b in
                             zip(r_own[:, :100].tolist(), r_dfs[:, :100].cpu().tolist())]))
    check(overlap >= 0.95, f"6k diffusion: top-100 overlap with the CPU's own graph {overlap}")
    out["diffusion"] = {"build_s": build_s, "knn_s": st["knn_s"], "sweep_s": st["sweep_s"],
                        "batches": -(-n // 256), "online_ms": online_ms,
                        "seed_rows": int(seeds.numel()),
                        "one_graph_solve_max_rel_err": sc_err,
                        "one_graph_dense_max_rel_err": dense_err,
                        "one_graph_top100_moved": moved, "one_graph_top100_max_rel_gap": gap,
                        "knn_rows_equal_cpu": int((knn_k.cpu() == knn_c).all(1).sum()),
                        "own_graph_seed_rows_same_support":
                            int((ids_k.sort(1).values == ids_c.sort(1).values).all(1).sum()),
                        "own_graph_seed_max_rel_err": rel(row_k, row_c),
                        "own_graph_top100_overlap": overlap}
    print(f"diffusion at {n} x {D} (alphaQE queries, n_trunc={T}, kd={kd}, tables solver): "
          f"{json.dumps(out['diffusion'])} ({card})", flush=True)
    del off, sims_k, knn_k, nbr_k, val_k, sims_c, lap_c

    # AQE and DBA: augmented descriptors and their exact ranks, card vs CPU
    for name, fn in (("aqe", rerank.average_query_expansion),
                     ("dba", rerank.database_augmentation)):
        qa, va = fn(qvecs, vecs)
        qa_c, va_c = fn(qc, vc)
        err = max(float((qa.cpu() - qa_c).abs().max()), float((va.cpu() - va_c).abs().max()))
        check(err <= 1e-4, f"{name}: card vs CPU descriptors differ by {err}")
        moved, gap = compare_ranks(exact_ranks(qa_c, va_c)[:, :100], exact_ranks(qa, va)[:, :100],
                                   exact_scores(qa_c, va_c), 1e-5, f"{name} card vs CPU")
        ms = time_ms(lambda: fn(qvecs, vecs), 10, flush)  # noqa: B023
        out[name] = {"ms": ms, "max_abs_err": err, "top100_moved": moved}
        print(f"{name} at {n} x {D}: {ms:.3f} ms, max |card - CPU| {err}, top-100 ranks moved "
              f"{moved} ({card})", flush=True)

    # k-reciprocal: dense on the card and the CPU, chunked on the card
    final_c = rerank.kr_rerank_scores(l2n(qc), l2n(vc))
    kr_c = torch.argsort(final_c, dim=1, stable=True)
    kr_ms = time_ms(lambda: rerank.kr_rerank(qvecs, vecs), 3, flush)
    kr = rerank.kr_rerank(qvecs, vecs)
    moved, gap = compare_ranks(kr_c[:, :100], kr[:, :100], final_c, 1e-5, "kr card vs CPU")
    final = rerank.kr_rerank_scores(l2n(qvecs), l2n(vecs))
    t0 = time.perf_counter()
    krc = rerank.kr_rerank_chunked(qvecs, vecs)
    torch.cuda.synchronize()
    krc_s = time.perf_counter() - t0
    moved_c, gap_c = compare_ranks(kr[:, :100], krc[:, :100], final, 1e-5,
                                   "kr chunked vs dense on the card")
    out["kr"] = {"rows": n + qvecs.shape[0], "dense_ms": kr_ms, "chunked_s": krc_s,
                 "top100_moved_vs_cpu": moved, "chunked_top100_moved_vs_dense": moved_c,
                 "chunked_first_rank_differing": int((kr != krc).float().argmax(1)
                                                     .masked_fill(~(kr != krc).any(1), n).min())}
    print(f"kr at {n + qvecs.shape[0]} rows: {json.dumps(out['kr'])} ({card})", flush=True)
    return out


def kr_large_phase(dev, card, n=100_000, nq=70):
    """k-reciprocal beyond the dense envelope: ``kr_rerank`` picks the chunked
    path; seconds, peak memory and whether the full-width re-run fired."""
    from image_search_engine_for_historical_research_tpu_torch.rerank import kr as kr_mod

    g = torch.Generator(device=dev).manual_seed(5)
    vecs = clustered_rows(n, D, g, dev).float()
    src = torch.randperm(n, generator=g, device=dev)[:nq]
    q = unit_rows(vecs[src] + 0.02 * torch.randn(nq, D, generator=g, device=dev) / D ** 0.5)
    runs = []
    program = kr_mod._kr_chunked_program

    def spy(*args, **kw):
        res = program(*args, **kw)
        runs.append({"compact_width": kw["compact_width"], "overflow": bool(res[1])})
        return res

    kr_mod._kr_chunked_program = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ranks = kr_mod.kr_rerank(q, vecs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        kr_mod._kr_chunked_program = program
    check(tuple(ranks.shape) == (nq, n), f"kr 100k ranks shape {tuple(ranks.shape)}")
    check(bool((torch.sort(ranks, dim=1).values == torch.arange(n, device=dev)).all()),
          "kr 100k: a row of ranks is not a permutation")
    hit = float((ranks[:, 0] == src).float().mean())
    check(hit >= 0.9, f"kr 100k: rank 0 is the query's own row for only {hit}")
    rec = {"gallery": n, "queries": nq, "dense_estimate_gib": 24 * (n + nq) ** 2 / 2 ** 30,
           "s": secs, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "runs": runs, "overflow_rerun": len(runs) > 1, "rank0_own_row": hit}
    print(f"kr_rerank beyond the dense envelope: {json.dumps(rec)} ({card})", flush=True)
    del vecs, ranks
    torch.cuda.empty_cache()
    return rec


def top_by_topk(s, k):
    """The alternative to ``ops.topk._top_exact``'s stable sort that this
    script times beside it, with the same result: ``torch.topk`` finds the
    k-th score, every score above it is kept, and the lowest ids among those
    equal to it fill the rest."""
    n = s.shape[1]
    kth = torch.topk(s, k, dim=1).values[:, -1:]
    above, tied = s > kth, s == kth
    take = above | (tied & (torch.cumsum(tied, 1) <= k - above.sum(1, keepdim=True)))
    col = torch.arange(n, device=s.device)
    i = torch.topk(torch.where(take, col, col + n), k, dim=1, largest=False).indices
    i = i.sort(dim=1).values
    v, perm = torch.sort(s.gather(1, i), dim=1, descending=True, stable=True)
    return v, i.gather(1, perm)


def top_exact_rows(cases, flush):
    """``ops.topk._top_exact`` (a stable sort's head) beside ``top_by_topk``
    on score rows with many exact ties: equal ids and scores, and each one's
    time with and without the host's launch gaps."""
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import _top_exact

    out = {}
    for label, s, k in cases:
        s = s.contiguous()
        v, i = _top_exact(s, k)
        v2, i2 = top_by_topk(s, k)
        check(torch.equal(i, i2) and torch.equal(v, v2),
              f"_top_exact and the topk form differ at {label}")
        sort = lambda: _top_exact(s, k)                                      # noqa: E731
        topk = lambda: top_by_topk(s, k)                                     # noqa: E731
        out[label] = {"ms": time_ms(sort, 20, flush), "topk_form_ms": time_ms(topk, 20, flush),
                      "device_ms": time_ms(sort, 20, flush, spin=True),
                      "topk_form_device_ms": time_ms(topk, 20, flush, spin=True)}
    return out


DIFFUSION_ROWS = 500_000    # of the 1M rows (cut for the script's time limit)


def diffusion_1m_phase(vecs, dev, flush, card, n_check=64):
    """Diffusion beyond the reference regime (120k rows) on ``vecs``, the
    first ``DIFFUSION_ROWS`` of the 1M bf16 rows: the device artifact under a
    budget of 3 GiB per 1M rows (T=512, recompute solver), n_check rows
    solved again by the tables solver over the same kNN graph, the online
    pass."""
    from image_search_engine_for_historical_research_tpu_torch.rerank import diffusion as dif

    n = vecs.shape[0]
    st = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    off = dif.build_diffusion_offline(vecs, kd=50, batch=1024, allow_large=True,
                                      memory_budget_bytes=(3 << 30) * n // N_BIG,
                                      host_out=False,
                                      score_dtype=np.float16, stats=st)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(st["solver"] == "recompute" and st["T"] == 512, f"diffusion build {st}")
    check(tuple(off.trunc_ids.shape) == (n, 512) and off.trunc_ids.dtype == torch.int32
          and off.scores.dtype == torch.float16, "diffusion artifact shape or dtype")
    check(bool(torch.isfinite(off.scores).all()), "diffusion artifact is not finite")
    self_first = float((off.trunc_ids[:, 0] == torch.arange(n, device=dev)).float().mean())
    check(self_first >= 0.999, f"diffusion: a row's support starts with itself {self_first}")

    sims, ids = st.pop("knn")
    lap_nbr, lap_val = dif._laplacian_from_knn(sims, ids)
    del sims, ids
    g = torch.Generator(device=dev).manual_seed(3)
    rows = torch.randperm(n, generator=g, device=dev)[:n_check]
    x_tab = dif._batched_trunc_cg(lap_nbr, lap_val, off.trunc_ids[rows])
    err = ((x_tab - off.scores[rows].float()).abs().amax(1)
           / x_tab.abs().amax(1).clamp(min=1e-30)).cpu()
    agree = int((err <= 1e-3).sum())
    del lap_nbr, lap_val
    check(agree >= n_check - 3, f"diffusion: {agree} of {n_check} rows agree with the "
                                f"tables solver within 1e-3 (worst {float(err.max())})")

    pick = torch.randperm(n, generator=g, device=dev)[:Q_BIG]
    q = unit_rows(vecs[pick].float() + 0.02 * torch.randn(Q_BIG, D, generator=g, device=dev)
                  / D ** 0.5).contiguous()
    online = lambda: dif.diffusion_online_scores(off.trunc_ids, off.scores, vecs, q)  # noqa: E731
    online_ms = time_ms(online, 5, flush)
    dense = online()
    check(tuple(dense.shape) == (Q_BIG, n) and bool(torch.isfinite(dense).all()),
          "diffusion online scores")
    top1 = float((dense.argmax(1) == pick).float().mean())
    # the top-k of the diffusion callers on dense score rows (mostly exact
    # zeros): the 1M rows at k=100 and the served gallery's width at K=10
    top_rec = top_exact_rows(((f"{n} Q=70 k=100", dense, 100),
                              ("4112 Q=1 k=10", dense[:1, :4112], 10),
                              ("4112 Q=4 k=10", dense[:4, :4112], 10)), flush)
    rec = {"n": n, "T": st["T"], "kd": 50, "batch": 1024, "solver": st["solver"],
           "build_s": build_s, "knn_s": st["knn_s"], "sweep_s": st["sweep_s"],
           "batches": -(-n // 1024), "peak_gib": peak,
           "artifact_gb": (off.trunc_ids.numel() * 4 + off.scores.numel() * 2) / 1e9,
           "tables_check_rows": n_check, "tables_agree_1e-3": agree,
           "tables_worst_rel_err": float(err.max()), "online_queries": Q_BIG,
           "online_ms": online_ms, "online_top1_own_row": top1, "top_exact": top_rec}
    print(f"diffusion at {n} bf16 rows beyond the regime: {json.dumps(rec)} ({card})",
          flush=True)
    del off, dense
    torch.cuda.empty_cache()
    return rec


BF16_FLOPS = 989e12         # H100 SXM bf16 dense tensor cores


def bound_of(nbytes, ops, flops=F32_FLOPS):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory rate
    and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class CallCounter:
    """Count the calls of functions where their callers look them up: each
    ``(module, name)`` is wrapped while the counter is entered."""

    def __init__(self, targets):
        self.targets, self.counts = targets, {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
            self.counts.setdefault(key, 0)

            def wrapped(*a, _fn=fn, _key=key, **kw):
                self.counts[_key] += 1
                return _fn(*a, **kw)

            self.saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def pq_targets():
    """The PQ family's device ops, where the indexes call them."""
    from image_search_engine_for_historical_research_tpu_torch.index import hnsw, ivfpq
    from image_search_engine_for_historical_research_tpu_torch.index import pq as index_pq

    return [(index_pq, "pq_search"), (index_pq, "pq_refine_rerank"), (hnsw, "pq_search"),
            (hnsw, "_rerank_refine"), (hnsw, "hnsw_search_batch_pq"),
            (hnsw, "hnsw_search_batch_pq_centroid"), (ivfpq, "_ivfpq_search"),
            (ivfpq, "_ivfpq_rerank_refine")]


def trace_op(fn):
    """One call of ``fn`` under ``torch.profiler`` (after a warm call): the
    device events it ran (kernels, copies, sets), their busy time (the union
    of their intervals), the span from the first event's start to the last
    one's end, the idle share of that span (the gaps between events, where
    the card waits for the host) and the three names with the most device
    time. ``{"error": ...}`` when the profiler records no device events on
    this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    except Exception as exc:  # the profiler is untried on some machines
        return {"error": repr(exc)}
    if not spans:
        return {"error": "no device events recorded"}
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = end - spans[0][0]
    by_name = {}
    for e in events:
        by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + (e.time_range.end
                                                               - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"device_events": len(spans), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0, "top_ms": top}


def compare_scored(s_ref, i_ref, s_got, i_got, rtol, label):
    """``got`` against ``ref`` rank by rank: where the ids differ, the two
    scores at that rank are within ``rtol`` (relative) of each other, i.e.
    the ids tie. Returns (ranks that differ, largest relative gap there)."""
    s_ref, i_ref, s_got, i_got = (torch.as_tensor(t).cpu() for t in (s_ref, i_ref, s_got, i_got))
    moved = i_ref.long() != i_got.long()
    gap = ((s_ref - s_got).abs() / s_ref.abs().clamp(min=1e-30))[moved]
    worst = float(gap.max()) if gap.numel() else 0.0
    check(worst <= rtol, f"{label}: ids differ beyond ties (relative gap {worst} > {rtol})")
    return int(moved.sum()), worst


def pq_1m_phase(vecs, dev, flush, card):
    """The PQ family at the reference script's scale on the graph phase's
    1M x 2048 bf16 rows: three builds, every search route's recall and
    times, the card against the CPU on one artifact, and the device ops
    beside their bounds."""
    from image_search_engine_for_historical_research_tpu_torch.index import (
        FlatIndex,
        build_hnsw_pq,
        build_ivfpq,
        build_pq,
        hnsw as hnsw_mod,
        ivfpq as ivf_mod,
        load_index,
        normalize_rows,
        save_index,
    )
    from image_search_engine_for_historical_research_tpu_torch.ops import graph_search as gs
    from image_search_engine_for_historical_research_tpu_torch.ops import pq as pq_ops
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import _top_exact

    n, d = vecs.shape
    q = vecs[:Q_BIG].float().contiguous()
    qn = normalize_rows(q)
    _, exact = FlatIndex(vectors=vecs, storage_dtype="bfloat16").search(q, 100)
    out = {"n": n, "d": d, "queries": Q_BIG, "builds": {}, "routes": {}, "ops": {}}
    tmp = tempfile.mkdtemp(prefix="pq1m_")

    def build(name, fn, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = {}
        t0 = time.perf_counter()
        ix = fn(vecs, stats=st, device=dev, **kw)
        torch.cuda.synchronize()
        st.update(total_s=time.perf_counter() - t0,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out["builds"][name] = st
        print(f"PQ build {name} {json.dumps(kw)}: {json.dumps(st)} ({card})", flush=True)
        path = os.path.join(tmp, name)
        save_index(ix, path)
        return ix, load_index(path, device="cpu")

    def route(name, ix, cpu_ix, reps=(5, 10), **kw):
        _, ids = ix.search(q, 100, **kw)
        rec = {"recall10": recall_at(exact, ids, 10), "recall100": recall_at(exact, ids, 100),
               "ms_q70": time_ms(lambda: ix.search(q, 100, **kw), reps[0], flush),
               "ms_q1": time_ms(lambda: ix.search(q[:1], 100, **kw), reps[1], flush)}
        s_g, i_g = ix.search(q[:8], 100, **kw)
        s_c, i_c = cpu_ix.search(q[:8].cpu(), 100, **kw)
        rec["cpu_ranks_moved"], rec["cpu_max_rel_gap"] = compare_scored(
            s_c, i_c, s_g, i_g, 1e-5, f"PQ route {name}: card vs CPU")
        out["routes"][name] = rec
        print(f"PQ route {name}: {json.dumps(rec)} ({card})", flush=True)
        return rec

    def op(name, fn, nbytes, ops, flops=F32_FLOPS, reps=10, **extra):
        ms = time_ms(fn, reps, flush)
        bnd, by = bound_of(nbytes, ops, flops)
        rec = {"ms": ms, "bound_ms": bnd, "bound_by": by, "share_of_bound": bnd / ms,
               "bytes": nbytes, "ops": ops, **extra, "trace": trace_op(fn)}
        out["ops"][name] = rec
        print(f"PQ op {name}: {json.dumps(rec)} ({card})", flush=True)

    # (a) Nano_PQ's point: the plain ADC scan
    a, a_cpu = build("pq", build_pq, M=16, Ks=8192)
    route("pq adc", a, a_cpu, method="adc")
    M, Ks, ds = a.codewords.shape
    for qq in (Q_BIG, 1):
        op(f"adc_scan Q={qq}", lambda qq=qq: pq_ops.pq_search(a.codebook, a.codes, qn[:qq], 100,
                                                               chunk=262144),
           n * M * 2 + M * Ks * ds * 4 + qq * d * 4 + qq * 100 * 12,
           qq * M * Ks * ds * 2 + n * M * qq, N=n, M=M, Ks=Ks)
    # the chunk top-k of the scan on its own score rows (rows sharing a code tie)
    s_adc = -pq_ops.adc(pq_ops.pq_dist_table(a.codebook, qn), pq_ops.codes_long(a.codes[:262144]))
    out["top_exact"] = top_exact_rows((("ADC 262144 Q=70 k=100", s_adc, 100),
                                       ("ADC 262144 Q=70 k=400", s_adc, 400),
                                       ("ADC 262144 Q=1 k=100", s_adc[:1], 100)), flush)
    print(f"PQ top-k of the scan's chunks: {json.dumps(out['top_exact'])} ({card})", flush=True)
    del s_adc
    st = out["builds"]["pq"]
    enc_ops = n * M * Ks * ds * 2
    bnd, by = bound_of(n * d * 4 + n * M * 2, enc_ops, BF16_FLOPS)
    out["ops"]["encode_pass"] = {"ms": st["encode_s"] * 1e3, "bound_ms": bnd, "bound_by": by,
                                 "share_of_bound": bnd / (st["encode_s"] * 1e3),
                                 "ops": enc_ops, "rows": n, "timer": "host clock after sync"}
    print(f"PQ op encode_pass: {json.dumps(out['ops']['encode_pass'])} ({card})", flush=True)
    del a, a_cpu
    torch.cuda.empty_cache()

    # (b) PQ + HNSW, the JAX package's recommended route (opq on the residual level)
    b, b_cpu = build("hnsw_pq", build_hnsw_pq, M=16, Ks=8192, m=16, opq="refine", refine_M=32)
    print(f"refine OPQ fit of the 1M build_hnsw_pq (M=32, Ks=256): "
          f"{out['builds']['hnsw_pq']['refine_fit_s']} s ({card})", flush=True)
    check(out["builds"]["hnsw_pq"]["builder"] == "device", "build_hnsw_pq did not pick the "
                                                           "device builder at 1M")
    print(f"HNSW-PQ unique codes U = {b.unique_codes.shape[0]}", flush=True)
    for name, kw in (("hnsw_pq adc", {"method": "adc"}),
                     ("hnsw_pq adc+refine", {"method": "adc+refine"}),
                     ("hnsw_pq graph+refine centroid", {"method": "graph+refine", "ef": 320,
                                                        "n_seeds": 32}),
                     ("hnsw_pq graph+refine coarse", {"method": "graph+refine", "ef": 320,
                                                      "n_seeds": 32, "centroid_walk": False})):
        # the walks take 0.6-0.9 s a call: fewer timed calls (a depth cut)
        route(name, b, b_cpu, reps=(2, 3) if kw["method"] == "graph+refine" else (5, 10), **kw)
    check(out["routes"]["hnsw_pq adc+refine"]["recall100"]
          >= out["routes"]["hnsw_pq adc"]["recall100"], "HNSW-PQ: adc+refine below adc")
    # the host expansion between the unique-code scan and the re-rank
    cb, rcb = pq_ops.PQCodebook(b.codewords, b.rotation), pq_ops.PQCodebook(
        b.refine_codewords, b.refine_rotation)
    E = 400
    s_u, i_u = pq_ops.pq_search(cb, b.unique_codes, qn, E)
    i_h, s_h = i_u.cpu().numpy(), s_u.cpu().numpy()
    t0 = time.perf_counter()
    _, o_idx, o_u, valid, _ = b._expand_members(i_h, s_h, E)
    out["ops"]["expand_members_host"] = {"ms": (time.perf_counter() - t0) * 1e3, "Q": Q_BIG,
                                         "slots": E, "timer": "host clock"}
    ou, oi, va = (torch.as_tensor(t, device=dev) for t in (o_u, o_idx, valid))
    Mr, Ksr, dsr = b.refine_codewords.shape
    op(f"refine_rerank hnsw_pq Q={Q_BIG} E={E}",
       lambda: hnsw_mod._rerank_refine(cb, b.unique_codes, rcb, b.refine_codes, qn, ou, oi, va, 100),
       Q_BIG * E * (M * 2 + Mr + 8) + (M * Ks * ds + Mr * Ksr * dsr + d * d) * 4,
       Q_BIG * E * d * 6 + Q_BIG * E * d * d * 2, E=E)
    for walk, centroid in (("pq_walk coarse", False), ("pq_walk centroid", True)):
        rows = {"n": 0}
        fn_name = "_pq2_dist" if centroid else "_adc"
        orig = getattr(gs, fn_name)

        def spy(*args, _orig=orig):
            ids = args[-1] if centroid else None
            if ids is not None:
                rows["n"] += int((ids >= 0).sum())
            else:   # LUT rows x code rows (one set, or a set per LUT row)
                rows["n"] += int(args[0].shape[0] * args[1].shape[-2])
            return _orig(*args)

        kw = dict(k=320, ef=320, coarse_ids=b.coarse_ids, n_seeds=32)
        if centroid:
            run = lambda: gs.hnsw_search_batch_pq_centroid(  # noqa: E731
                b.unique_codes, b.codewords, b.node_codes, b.refine_codewords, b.node_norm2,
                b.nbr0, b.nbru, b.entry, qn, rotation=b.rotation, node_rotation=b.refine_rotation,
                **kw)
            per_row = M * 2 + Mr + 4 + 4
        else:
            run = lambda: gs.hnsw_search_batch_pq(  # noqa: E731
                b.unique_codes, b.codewords, b.nbr0, b.nbru, b.entry, qn, **kw)
            per_row = M * 2 + 4
        setattr(gs, fn_name, spy)
        try:
            run()
        finally:
            setattr(gs, fn_name, orig)
        op(walk, run, rows["n"] * per_row, rows["n"] * (M + (Mr + 3 if centroid else 0)),
           reps=3, rows_scored=rows["n"], ef=320, n_seeds=32)
    del b, b_cpu, ou, oi, va
    torch.cuda.empty_cache()

    # (c) IVF-PQ: FAISS knn.py's defaults plus refine codes
    c, c_cpu = build("ivfpq", build_ivfpq, nlist=316, M=16, Ks=256, nprobe=64, refine_M=32)
    for name, kw in (("ivfpq adc", {"method": "adc"}), ("ivfpq adc+refine", {"method": "adc+refine"})):
        route(name, c, c_cpu, **kw)
    check(out["routes"]["ivfpq adc+refine"]["recall100"] >= out["routes"]["ivfpq adc"]["recall100"],
          "IVF-PQ: adc+refine below adc")
    Mc, Ksc, dsc = c.codewords.shape
    nl = c.coarse_centers.shape[0]
    c2 = (c.coarse_centers ** 2).sum(1)
    _, probe = _top_exact(-(c2[None] - 2.0 * (qn @ c.coarse_centers.T)), c.nprobe)
    slots = int(c.lens[probe].long().sum())
    probe_args = (c.coarse_centers, c.codewords, c.flat_codes, c.flat_ids, c.offsets, c.lens, qn,
                  c.rotation, E, c.nprobe, c.seg)
    op(f"ivf_probe Q={Q_BIG} k={E}", lambda: ivf_mod._ivfpq_search(*probe_args),
       slots * (Mc + 4) + nl * d * 4 + Mc * Ksc * dsc * 4 + Q_BIG * d * 4 + Q_BIG * E * 16,
       Q_BIG * nl * d * 2 + Q_BIG * c.nprobe * Mc * Ksc * dsc * 2 + slots * Mc,
       scanned_slots=slots, seg=c.seg, lists=nl, nprobe=c.nprobe)
    _, ci, cp = ivf_mod._ivfpq_search(*probe_args)
    rMr, rKs, rds = c.refine_codewords.shape
    op(f"refine_rerank ivfpq Q={Q_BIG} E={E}",
       lambda: ivf_mod._ivfpq_rerank_refine(
           c.coarse_centers, pq_ops.PQCodebook(c.codewords, c.rotation), c.flat_codes,
           c.flat_list, pq_ops.PQCodebook(c.refine_codewords, None), c.flat_refine, qn, cp, ci,
           100),
       Q_BIG * E * (Mc + rMr + 8 + d * 4) + (Mc * Ksc * dsc + rMr * rKs * rds) * 4,
       Q_BIG * E * d * 8, E=E)
    del c, c_cpu
    torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return out


def pq_determinism_phase(vecs, dev, card, rows=65_536):
    """Two card builds from one seed give identical arrays (PQ, IVF-PQ and
    HNSW-PQ with the device graph builder and the node centroid sums), and
    streamed PQ builds equal the in-memory build given the same explicit
    ``train_sample``: normalized rows, OPQ on both levels, refine codes, from
    device bf16 chunks whose size is not on the build grid (host chunks:
    the ``cuda`` tests). The fits use the 1M phase's Ks=8192 on ``rows``
    rows: the checks are of identity, which the row count does not change,
    and the script's time limit needs the cut."""
    from image_search_engine_for_historical_research_tpu_torch.index import (
        build_hnsw_pq,
        build_ivfpq,
        build_pq,
    )

    sub = vecs[:rows]

    def arrays(ix):
        return ix.to_arrays()[1]

    def same(a, b, label):
        check(set(a) == set(b), f"{label}: array names differ")
        for k in a:
            check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                  f"{label}: array {k} differs")

    out = {"rows": rows}
    t0 = time.perf_counter()
    same(arrays(build_pq(sub, M=16, Ks=8192, device=dev)),
         arrays(build_pq(sub, M=16, Ks=8192, device=dev)), "two build_pq from one seed")
    kw = dict(nlist=316, M=16, Ks=256, nprobe=64, refine_M=32, device=dev)
    same(arrays(build_ivfpq(sub, **kw)), arrays(build_ivfpq(sub, **kw)),
         "two build_ivfpq from one seed")
    out["pq_ivfpq_twice_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one OPQ round and a 65,536-row fit sample: the checks need no more
    kw = dict(M=16, Ks=8192, m=16, opq="refine", opq_iters=1, refine_M=32, builder="device",
              train_sample=65536, device=dev)
    st = {}
    same(arrays(build_hnsw_pq(sub, stats=st, **kw)), arrays(build_hnsw_pq(sub, **kw)),
         "two build_hnsw_pq (device builder) from one seed")
    out["hnsw_pq_twice_s"], out["hnsw_pq_U"] = time.perf_counter() - t0, st["U"]
    t0 = time.perf_counter()
    kw = dict(M=16, Ks=8192, train_sample=65536, refine_M=32, opq=True, opq_iters=1, device=dev)
    step = 50_000                               # not a multiple of any encode or grid piece
    stream = build_pq(lambda: (sub[s:s + step] for s in range(0, rows, step)), n=rows, **kw)
    same(arrays(build_pq(sub, **kw)), arrays(stream),
         f"streaming build_pq from {step}-row device chunks vs in memory")
    out["streaming_s"] = time.perf_counter() - t0
    out["identical"] = True
    print(f"PQ determinism and streaming at {rows} rows: identical arrays {json.dumps(out)} "
          f"({card})", flush=True)
    return out


def served_scored(svc, search_ids):
    """The service's qge1 re-rank (``SearchService._rerank``) of a search's
    ids ``(1, K)``, with the scores it ranks by: ``(scores, ids)`` on the
    CPU."""
    from image_search_engine_for_historical_research_tpu_torch.ops.topk import _top, exact_scores
    from image_search_engine_for_historical_research_tpu_torch.rerank import qe

    check(svc.rerank == "qge1", f"served re-rank {svc.rerank}, want qge1")
    ranks = torch.as_tensor(search_ids, device=svc.device)
    q = qe._enhance(ranks, svc._vecs_dev, min(3, ranks.shape[1]), 4.0)
    s, i = _top(exact_scores(q, svc._vecs_dev), min(svc.K, svc.vecs.shape[0]))
    return s.cpu(), i.cpu()


def pq_serving_phase(offline, online, common, argv, paths, dev, card):
    """``cli.offline`` builds each PQ-family artifact over the served gallery
    and ``cli.online.make_service`` serves it: 4 WSGI POSTs, one query_batch
    of the same 4 (equal ids), one query on a CPU service (its search equal
    to the card's but at ties; each service's served ids the re-rank of its
    search; the card's re-rank of the CPU's search equal to the CPU's served
    list but at tied scores), with the PQ ops counted on the card's served
    path."""
    from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app

    from image_search_engine_for_historical_research_tpu_torch.index import pq as index_pq
    from image_search_engine_for_historical_research_tpu_torch.models.extract import (
        extract_vectors_single,
    )

    out = {}
    fit_s = []
    opq_train = index_pq.opq_train

    def timed_opq_train(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb = opq_train(*a, **kw)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        return cb

    # the CLI's default 32-byte refine codes on both refine routes
    for method, extra in (("HNSW_NanoPQ", ["--opq", "refine", "--refine-m", "32"]),
                          ("IVFPQ", ["--refine-m", "32"]), ("PQ", [])):
        t0 = time.perf_counter()
        index_pq.opq_train = timed_opq_train
        try:
            check(offline.main(["--datasets", "images,synthetic", "--ifextracted", "--ifgenerate",
                                "--matching-method", method] + extra + common) == 0,
                  f"cli.offline {method} failed")
        finally:
            index_pq.opq_train = opq_train
        build_s = time.perf_counter() - t0
        if method == "HNSW_NanoPQ":
            check(len(fit_s) == 1, f"HNSW_NanoPQ --opq refine ran {len(fit_s)} OPQ fits, want 1")
            out["refine_opq_fit_s"] = fit_s[0]
            print(f"refine OPQ fit of the served HNSW_NanoPQ (M=32, Ks=256, 4,112 rows): "
                  f"{fit_s[0]} s ({card})", flush=True)
        margv = [("PQ_METHOD" if a == "HNSW" else a) for a in argv]
        margv[margv.index("PQ_METHOD")] = method
        svc = online.make_service(online.build_parser().parse_args(margv + ["--device", dev.type]))
        app = make_wsgi_app(svc)
        post(app, paths[15])                                 # warm-up, outside the count
        with CallCounter(pq_targets()) as calls:
            posted = [post(app, p) for p in paths[:4]]
            batch = svc.query_batch(paths[:4])
            torch.cuda.synchronize()
        ids = [[r["id"] for r in o["results"]] for o in posted]
        for i, row in enumerate(ids):
            check(len(row) == 10 and len(set(row)) == 10, f"{method} POST {i}: ids {row}")
        check([[r["id"] for r in res] for res, _ in batch] == ids,
              f"{method}: query_batch ids differ from the POSTs'")
        cpu = online.make_service(online.build_parser().parse_args(margv + ["--device", "cpu"]))
        cpu_ids = [r["id"] for r in cpu.query_image(paths[0])[0]]
        # each service's search of the query under its own descriptor: at
        # 32-byte refine codes the 16 near-parallel image descriptors
        # reconstruct to scores a float ulp apart, so the two searches may
        # order them as ties; each service serves the qge1 re-rank of its
        # own search, and the card's re-rank of the CPU's search must give
        # the CPU's served list, ids free only at tied served scores
        sg, ig = svc.index.search(torch.as_tensor(extract_vectors_single(
            svc.model, paths[0], svc.image_size, scales=svc.scales))[None], svc.K)
        sc, ic = cpu.index.search(torch.as_tensor(extract_vectors_single(
            cpu.model, paths[0], cpu.image_size, scales=cpu.scales))[None], cpu.K)
        moved, gap = compare_scored(sc, ic, sg, ig, 1e-5, f"{method}: served search, CPU vs card")
        s_card, i_card = served_scored(svc, ig)
        s_cpu, i_cpu = served_scored(cpu, ic)
        check(i_card[0].tolist() == ids[0], f"{method}: card service ids {ids[0]} are not the "
                                            f"re-rank of its search {i_card[0].tolist()}")
        check(i_cpu[0].tolist() == cpu_ids, f"{method}: CPU service ids {cpu_ids} are not the "
                                            f"re-rank of its search {i_cpu[0].tolist()}")
        s_x, i_x = served_scored(svc, ic)
        served_moved, served_gap = compare_scored(
            s_x, i_x, s_cpu, i_cpu, 1e-5, f"{method}: served results, CPU vs card on one search")
        cpu.close()
        t = posted[0]["timing"]
        g = torch.Generator(device=dev).manual_seed(5)
        qv = unit_rows(torch.randn(1, D, generator=g, device=dev))
        rec = {"search_trace_q1": trace_op(lambda: svc.index.search(qv, svc.K)),"offline_s": build_s, "kind": type(svc.index).__name__,
               "search_s": [o["timing"]["search_s"] for o in posted],
               "rerank_s": t["rerank_s"], "extract_s": t["extract_s"],
               "batch_search_s": batch[0][1]["search_s"], "op_calls": dict(calls.counts),
               "cpu_search_ranks_at_ties": moved, "cpu_search_tie_gap": gap,
               "cpu_served_ranks_at_ties": served_moved, "cpu_served_tie_gap": served_gap,
               "cpu_served_ids_equal": cpu_ids == ids[0],
               "rank0_own_image": sum(row[0] == i for i, row in enumerate(ids))}
        out[method] = rec
        print(f"PQ serving {method} {' '.join(extra)}: {json.dumps(rec)} ({card})", flush=True)
        svc.close()
    return out


def cli_phase(rr, tmp, image_paths, ckpt, dev, card):
    """The CLIs on stored features at rParis6k's shape (the re-ranking
    phase's rows and gnd written as a feature store and a gnd pickle), and
    ``test_custom`` / ``retrieve`` on the JPEGs in label folders."""
    import pickle
    import shutil

    from image_search_engine_for_historical_research_tpu_torch.cli import (
        benchmark,
        retrieve,
        test_custom,
        test_reranking,
    )
    from image_search_engine_for_historical_research_tpu_torch.data import save_path_feature
    from image_search_engine_for_historical_research_tpu_torch.evaluation.ranks import (
        load_ranked_results,
    )

    root, outputs = os.path.join(tmp, "revisited"), os.path.join(tmp, "rout")
    imlist = [f"db{i:05d}" for i in range(rr["n"])]
    qimlist = [f"q{i:02d}" for i in range(rr["nq"])]
    os.makedirs(os.path.join(root, "rparis6k"))
    with open(os.path.join(root, "rparis6k", "gnd_rparis6k.pkl"), "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": rr["gnd"]}, f)
    save_path_feature("rparis6k", rr["vecs"].cpu().numpy(), imlist, root=outputs)
    save_path_feature("rparis6k_queries", rr["qvecs"].cpu().numpy(), qimlist, root=outputs)
    common = ["--data-root", root, "--outputs", outputs, "--device", dev.type]

    def valid(res):
        return all(0.0 <= getattr(res, k) <= 1.0 + 1e-9 for k in ("mapE", "mapM", "mapH"))

    t0 = time.perf_counter()
    res = benchmark.run(benchmark.build_parser().parse_args(
        ["--datasets", "rparis6k", "--ifextracted", "--qge", "--matching-method", "L2"]
        + common))["rparis6k"]
    bench_s = time.perf_counter() - t0
    check(res["ranks_dfs"].shape == (rr["nq"], 2000), f"ranks_dfs {res['ranks_dfs'].shape}")
    check(all(valid(res[k]) for k in ("map", "map_qe", "map_dfs")), "benchmark mAP out of range")
    maps = {k: [res[k].mapE, res[k].mapM, res[k].mapH] for k in ("map", "map_qe", "map_dfs")}
    print(f"cli.benchmark --ifextracted --qge rparis6k: {bench_s} s, mAP E/M/H {json.dumps(maps)} "
          f"({card})", flush=True)

    t0 = time.perf_counter()
    rres = test_reranking.run(test_reranking.build_parser().parse_args(
        ["--dataset", "rparis6k", "--methods", "qge,aqe,dba,kr,diffusion"] + common))
    rr_s = time.perf_counter() - t0
    check(list(rres) == ["baseline", "qge", "aqe", "dba", "kr", "diffusion"]
          and all(valid(r) for r in rres.values()), "test_reranking results")
    check(rres["qge"].mapE == res["map_dfs"].mapE, "test_reranking qge and benchmark --qge "
                                                  "disagree")
    print(f"cli.test_reranking qge,aqe,dba,kr,diffusion: {rr_s} s, mAP E/M/H "
          f"{json.dumps({k: [r.mapE, r.mapM, r.mapH] for k, r in rres.items()})} ({card})",
          flush=True)

    custom = os.path.join(tmp, "custom")
    for i, src in enumerate(image_paths):
        for split in (("db", "q") if i < 4 else ("db",)):
            d = os.path.join(custom, split, f"label{i % 4}")
            os.makedirs(d, exist_ok=True)
            shutil.copy(src, d)
    args = ["--db-dir", os.path.join(custom, "db"), "--query-dir", os.path.join(custom, "q"),
            "--K", "10", "--save-ranks", "--html-sheet", "--network-path", ckpt,
            "--batch-size", "4", "--device", dev.type]
    t0 = time.perf_counter()
    cres = test_custom.run(test_custom.build_parser().parse_args(
        args + ["--outputs", os.path.join(tmp, "cout")]))
    custom_s = time.perf_counter() - t0
    ranks, qp, dp = load_ranked_results(os.path.join(tmp, "cout", "ranks"))
    own = [dp.index(p.replace(f"{os.sep}q{os.sep}", f"{os.sep}db{os.sep}")) for p in qp]
    check(ranks.shape == (4, 10) and list(ranks[:, 0]) == own,
          f"test_custom: rank 0 is not the query's own copy ({ranks[:, 0]}, {own})")
    check(0.0 < cres["map"] <= 1.0 and os.path.exists(cres["saved"]["html"]),
          f"test_custom mAP {cres['map']}")
    t0 = time.perf_counter()
    check(retrieve.main(["--mode", "custom"] + args + ["--outputs", os.path.join(tmp, "rtout")])
          == 0, "cli.retrieve --mode custom failed")
    retrieve_s = time.perf_counter() - t0
    check(np.array_equal(load_ranked_results(os.path.join(tmp, "rtout", "ranks"))[0], ranks),
          "cli.retrieve and cli.test_custom ranks differ")
    print(f"cli.test_custom on 16 JPEGs in 4 label folders: mAP@10 {cres['map']}, {custom_s} s; "
          f"cli.retrieve --mode custom: the same ranks, {retrieve_s} s ({card})", flush=True)
    return {"benchmark_s": bench_s, "map_dfs": maps["map_dfs"], "test_reranking_s": rr_s,
            "test_custom_s": custom_s, "retrieve_s": retrieve_s}


def served_rerank_phase(bs, svc, make_cpu_service, gallery, paths, tmp, data_root, dev, card):
    """Diffusion served over the HNSW service's gallery (a card-built
    artifact; 4 POSTs, 4 ``query_image``, one ``query_batch`` of 4; a CPU
    service and a host artifact give the same ids), then 16 POSTs from 8
    threads through ``CoalescingService``. Returns the beam kernel's launches
    in each of the two runs' counted parts: (diffusion, coalescing record)."""
    from image_search_engine_for_historical_research_tpu_torch.rerank import (
        DiffusionOffline,
        build_diffusion_offline,
    )
    from image_search_engine_for_historical_research_tpu_torch.serving import (
        CoalescingService,
        SearchService,
        make_wsgi_app,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = build_diffusion_offline(torch.as_tensor(gallery, device=dev), n_trunc=2000, kd=50)
    off_s = time.perf_counter() - t0
    off_path = os.path.join(tmp, "diffusion_offline.npz")
    off.save(off_path)
    print(f"served diffusion artifact: {gallery.shape[0]} rows, n_trunc=2000, kd=50, "
          f"build {off_s} s ({card})", flush=True)

    def diffusion_service(base, artifact, device):
        return SearchService(base.model, base.index, base.vecs, base.paths, K=10,
                             scales=base.scales, image_size=base.image_size,
                             rerank="diffusion", diffusion_offline=artifact,
                             image_root=data_root, device=device)

    dsvc = diffusion_service(svc, off, dev)
    dapp = make_wsgi_app(dsvc)
    post(dapp, paths[15])                                # warm-up, outside the count
    bs.launches = 0
    d_posted = [post(dapp, p) for p in paths[:4]]
    d_singles = [dsvc.query_image(p) for p in paths[4:8]]
    d_batch = dsvc.query_batch(paths[4:8])
    torch.cuda.synchronize()
    d_launches = bs.launches
    check(d_launches == 9, f"diffusion service: beam kernel launched {d_launches} times, "
                           "want 9")
    check([[r["id"] for r in res] for res, _ in d_singles]
          == [[r["id"] for r in res] for res, _ in d_batch],
          "diffusion query_batch differs from query_image")
    for i, out in enumerate(d_posted):
        ids = [r["id"] for r in out["results"]]
        t = out["timing"]
        check(len(ids) == 10 and len(set(ids)) == 10, f"diffusion POST {i}: ids {ids}")
        print(f"diffusion POST img{i:02d}: top-10 {ids} extract_s {t['extract_s']:.4f} "
              f"search_s {t['search_s']:.4f} rerank_s {t['rerank_s']:.4f} ({card})")
    t = d_batch[0][1]
    print(f"diffusion query_batch B=4: extract_s {t['extract_s']:.4f} search_s "
          f"{t['search_s']:.4f} rerank_s {t['rerank_s']:.4f} ({card})", flush=True)
    d_ids = [r["id"] for r in d_posted[0]["results"]]
    cpu_base = make_cpu_service()
    dcpu = diffusion_service(cpu_base, DiffusionOffline.load(off_path, device="cpu"), "cpu")
    cpu_d_ids = [r["id"] for r in dcpu.query_image(paths[0])[0]]
    print(f"diffusion cpu ids {cpu_d_ids} gpu ids {d_ids}", flush=True)
    check(cpu_d_ids == d_ids, "CPU and GPU diffusion services disagree")
    dcpu.close()
    cpu_base.close()
    hsvc = diffusion_service(svc, DiffusionOffline.load(off_path, to_device=False), dev)
    host_ids = [[r["id"] for r in hsvc.query_image(p)[0]] for p in paths[:4]]
    check(host_ids == [[r["id"] for r in o["results"]] for o in d_posted],
          "host and device diffusion artifacts disagree")
    t_host = hsvc.query_batch(paths[4:8])
    check([[r["id"] for r in res] for res, _ in t_host]
          == [[r["id"] for r in res] for res, _ in d_batch],
          "host-artifact query_batch differs")
    print(f"host artifact: the same ids for 4 query_image and a query_batch of 4; "
          f"batch rerank_s {t_host[0][1]['rerank_s']:.4f} ({card})", flush=True)
    hsvc.close()
    dsvc.close()
    del off

    # coalescing: 16 POSTs from 8 threads through one CoalescingService
    expected = {p: [r["id"] for r in svc.query_image(p)[0]] for p in paths}
    cs = CoalescingService(svc, max_batch=8)
    capp = make_wsgi_app(cs)
    got, errors = {}, []

    def client(part):
        try:
            for p in part:
                got[p] = [r["id"] for r in post(capp, p)["results"]]
        except Exception as e:  # noqa: BLE001 - collected and checked below
            errors.append(e)

    bs.launches = 0
    threads = [threading.Thread(target=client, args=(paths[i::8],)) for i in range(8)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    c_launches = bs.launches
    cs.close()
    check(not errors, f"coalesced requests failed: {errors}")
    check(got == expected, "coalesced ids differ from query_image's")
    coalesce_rec = {"requests_served": cs.requests_served, "batches_run": cs.batches_run,
                    "requests_per_batch": cs.requests_served / cs.batches_run,
                    "beam_launches": c_launches, "wall_s": c_wall}
    print(f"coalescing, 16 POSTs from 8 threads, max_batch=8: {json.dumps(coalesce_rec)} "
          f"({card})", flush=True)
    check(cs.requests_served == 16 and cs.batches_run < cs.requests_served,
          f"coalescing: {cs.batches_run} batches for {cs.requests_served} requests")
    check(c_launches == cs.batches_run, f"coalescing: {c_launches} beam launches for "
                                        f"{cs.batches_run} batches")

    return d_launches, coalesce_rec


INT8_OPS = 1979e12           # H100 SXM int8 dense tensor cores


def matchers_1m_phase(vecs, dev, flush, card):
    """The remaining matchers on the graph phase's 1M x 2048 bf16 rows (70 of
    them as queries, against ``FlatIndex``'s exact top-100): the RP-forest
    (100 trees, leaf 512), the int8 flat index with and without its bf16
    re-rank copy, LSH at 512 bits, Greedyhash codes (the signs of a seeded
    projection to 512 bits), PQ_Net over ``pq_train`` codewords (M=16,
    Ks=256) and PQ_Net_bucket (10 buckets), and the fractional distance on
    the first 100,000 rows. For each: build seconds and peak memory,
    recall@10/@100, ms at Q=70 and Q=1 beside the bound of its work, a
    ``trace_op`` trace, and the ids of 8 queries against a CPU run of the
    same arrays (equal but at ties)."""
    from image_search_engine_for_historical_research_tpu_torch.index import (
        FlatIndex,
        Int8FlatIndex,
        RPForestIndex,
        build_flat_i8,
        build_rpforest,
        normalize_rows,
    )
    from image_search_engine_for_historical_research_tpu_torch.index import matchers as mt
    from image_search_engine_for_historical_research_tpu_torch.index import rpforest as rp
    from image_search_engine_for_historical_research_tpu_torch.ops import hashing, kmeans
    from image_search_engine_for_historical_research_tpu_torch.ops import pq as pq_ops
    from image_search_engine_for_historical_research_tpu_torch.ops.softpq import (
        codewords_flat,
        codewords_from_flat,
    )

    n, d = vecs.shape
    q = vecs[:Q_BIG].float().contiguous()
    qn = normalize_rows(q)
    _, exact = FlatIndex(vectors=vecs, storage_dtype="bfloat16").search(q, 100)
    out = {"n": n, "d": d, "queries": Q_BIG, "builds": {}, "methods": {}}

    def build(name, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = {}
        t0 = time.perf_counter()
        obj = fn(st)
        torch.cuda.synchronize()
        st.update(total_s=time.perf_counter() - t0,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out["builds"][name] = st
        print(f"matchers build {name}: {json.dumps(st)} ({card})", flush=True)
        return obj

    def method(name, search, cpu_search, nbytes, ops, rate=F32_FLOPS, truth=exact, reps=5,
               score=None, **extra):
        """``search(queries) -> (scores, ids)`` on the card, ``cpu_search``
        on the CPU; ``score(ids, queries)`` re-scores ids on the CPU where
        the search returns none."""
        _, ids = search(q)
        rec = {"recall10": recall_at(truth, ids, 10), "recall100": recall_at(truth, ids, 100),
               "ms_q70": time_ms(lambda: search(q), reps, flush),
               "ms_q1": time_ms(lambda: search(q[:1]), reps, flush)}
        bnd, by = bound_of(nbytes, ops, rate)
        rec.update(bound_ms=bnd, bound_by=by, share_of_bound=bnd / rec["ms_q70"], bytes=nbytes,
                   ops=ops, **extra)
        rec["trace"] = trace_op(lambda: search(q))
        s_g, i_g = search(q[:8])
        s_c, i_c = cpu_search(q[:8].cpu())
        if score is not None:
            s_g, s_c = score(torch.as_tensor(i_g).cpu()), score(torch.as_tensor(i_c).cpu())
        rec["cpu_ranks_moved"], rec["cpu_max_rel_gap"] = compare_scored(
            s_c, i_c, s_g, i_g, 1e-5, f"matcher {name}: card vs CPU")
        out["methods"][name] = rec
        print(f"matcher {name}: {json.dumps(rec)} ({card})", flush=True)
        return rec

    # ANNOY: the RP-forest at the reference script's 100 trees
    forest = build("rpforest T=100 leaf=512", lambda st: build_rpforest(
        vecs, n_trees=100, leaf_size=512, device=dev, stats=st))
    T, L, leaf_max = forest.leaf_items.shape
    out["builds"]["rpforest T=100 leaf=512"].update(depth=forest.depth, leaf_max=leaf_max)
    cpu_forest = RPForestIndex(forest.vectors.cpu(), forest.planes.cpu(),
                               forest.thresholds.cpu(), forest.leaf_items.cpu(), forest.depth)
    leaf = rp._descend(forest.planes, forest.thresholds, qn, forest.depth)
    cand = forest.leaf_items[torch.arange(T, device=dev)[None, :], leaf].reshape(Q_BIG, -1)
    cand = torch.sort(cand, dim=1).values
    fresh = (cand >= 0) & torch.cat([torch.ones_like(cand[:, :1], dtype=torch.bool),
                                     cand[:, 1:] != cand[:, :-1]], 1)
    rows = int(fresh.sum())            # each query's distinct candidates
    descent = Q_BIG * T * forest.depth * d
    method("ANNOY rpforest", lambda x: forest.search(x, 100), lambda x: cpu_forest.search(x, 100),
           rows * d * 4 + descent * 2 + Q_BIG * d * 4, rows * d * 2 + descent * 2,
           candidate_rows=rows, query_chunk=max(8, rp.GATHER_BYTES // (T * leaf_max * d)))
    check(out["methods"]["ANNOY rpforest"]["recall10"] >= 0.8, "RP-forest recall@10 below 0.8")
    del forest, cpu_forest, leaf, cand, fresh
    torch.cuda.empty_cache()

    # L2_int8, with and without the bf16 re-rank copy
    for rerank in ("bfloat16", "none"):
        ix = build(f"flat_i8 rerank={rerank}", lambda st: build_flat_i8(vecs, rerank=rerank,
                                                                        device=dev))
        cpu_ix = Int8FlatIndex(ix.codes.cpu(), ix.scales.cpu(),
                               None if ix.rerank_vectors is None else ix.rerank_vectors.cpu(),
                               ix.shortlist)
        k_scan = ix.shortlist if rerank == "bfloat16" else 100
        gather = Q_BIG * ix.shortlist * d * 2 if rerank == "bfloat16" else 0
        method(f"L2_int8 rerank={rerank}", lambda x: ix.search(x, 100),
               lambda x: cpu_ix.search(x, 100),
               n * d + n * 4 + Q_BIG * d * 4 + Q_BIG * k_scan * 8 + gather,
               Q_BIG * n * d * 2, INT8_OPS, scan_k=k_scan)
        check(out["methods"][f"L2_int8 rerank={rerank}"]["recall100"] >= 0.9,
              f"int8 rerank={rerank}: recall@100 below 0.9")
        del ix, cpu_ix
        torch.cuda.empty_cache()

    # LSH at 512 bits (the port's seeded hyperplanes) and Greedyhash-style
    # codes (the signs of a seeded card projection): one Hamming scan each
    g = torch.Generator(device=dev).manual_seed(21)
    for name, planes in (("LSH 512 bits", hashing.lsh_hyperplanes(d, 512, device=dev)),
                         ("Greedyhash 512 bits", torch.randn(512, d, generator=g, device=dev))):
        db_codes = build(name, lambda st: hashing.lsh_encode(planes, vecs))
        W = db_codes.shape[1]
        cpu_codes = db_codes.cpu()

        def encode(x, planes=planes):
            return hashing.lsh_encode(planes, normalize_rows(x.to(dev)))

        method(name, lambda x: hashing.hamming_topk(db_codes, encode(x), 100),
               lambda x: hashing.hamming_topk(cpu_codes, encode(x).cpu(), 100),
               n * W * 4 + Q_BIG * d * 4 + Q_BIG * 100 * 8, Q_BIG * n * W * 3, words=W)
        del db_codes, cpu_codes
    torch.cuda.empty_cache()

    # PQ_Net over pq_train codewords (M=16, Ks=256), flat and bucketed
    cb = build("pq_train M=16 Ks=256", lambda st: pq_ops.pq_train(vecs, M=16, Ks=256,
                                                                   train_sample=65536))
    codes = pq_ops.codes_long(pq_ops.pq_encode(cb, vecs)).to(torch.int32)
    flat = codewords_flat(cb.codewords)
    cw = pq_ops.PQCodebook(codewords_from_flat(flat, 16))
    cw_cpu = pq_ops.PQCodebook(cw.codewords.cpu())
    codes_cpu = codes.cpu()
    M, Ks, ds = cw.codewords.shape
    method("PQ_Net M=16 Ks=256", lambda x: pq_ops.pq_search(cw, codes, x, 100),
           lambda x: pq_ops.pq_search(cw_cpu, codes_cpu, x, 100),
           n * M * 4 + M * Ks * ds * 4 + Q_BIG * d * 4 + Q_BIG * 100 * 12,
           Q_BIG * M * Ks * ds * 2 + n * M * Q_BIG)
    flat_np, codes_np = flat.cpu().numpy(), codes_cpu.numpy()
    gallery = vecs.float()
    centers, labels = build("PQ_Net_bucket k-means 10", lambda st: kmeans.kmeans_fit(
        gallery, 10, iters=20))
    del gallery
    labels = labels.cpu().numpy()
    counts = np.bincount(labels, minlength=10)
    qb = kmeans._assign(q, centers).cpu().numpy()
    scanned = int(counts[qb].sum())

    def bucket(x):
        idx, _ = mt.pq_net_bucket_search(100, flat_np, x, 16, codes_np, centers.to(x.device),
                                         labels)
        return None, torch.as_tensor(idx)

    def bucket_scores(ids, x=q[:8].cpu()):
        lut = pq_ops.pq_dist_table(cw_cpu, x)
        s = -pq_ops.adc(lut, codes_cpu.long()[ids.clamp(min=0)])
        return torch.where(ids >= 0, s, float("-inf"))

    method("PQ_Net_bucket 10", bucket, bucket, scanned * M * 4 + Q_BIG * M * Ks * 4,
           scanned * M + Q_BIG * M * Ks * ds * 2, score=bucket_scores,
           bucket_rows=counts.tolist(), scanned_rows=scanned)
    del codes, codes_cpu, centers
    torch.cuda.empty_cache()

    # fractional distance on the first 100,000 rows (O(Q N D), kept for parity)
    nf = 100_000
    sub = normalize_rows(vecs[:nf].float())
    sub_cpu = sub.cpu()
    _, exact_sub = FlatIndex(vectors=sub).search(q, 100)
    method("fractional p=0.5 N=100000",
           lambda x: hashing.fractional_topk(sub, normalize_rows(x), 100),
           lambda x: hashing.fractional_topk(sub_cpu, normalize_rows(x), 100),
           nf * d * 4 + Q_BIG * d * 4 + Q_BIG * 100 * 8, Q_BIG * nf * d * 4, truth=exact_sub,
           reps=3, rows=nf)
    del sub, sub_cpu
    torch.cuda.empty_cache()
    return out


def matchers_serving_phase(offline, online, common, argv, paths, card):
    """The remaining matchers through ``cli.offline --loader pil`` on the served
    gallery, and ``cli.online --matching-method ANNOY``: 4 WSGI POSTs, each
    one's ids equal to a CPU-built service's ``query_image``."""
    from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app

    out = {"offline_s": {}}
    for method in ("L2_int8", "fractional", "LSH", "ANNOY", "Greedyhash"):
        t0 = time.perf_counter()
        check(offline.main(["--datasets", "images,synthetic", "--ifextracted", "--ifgenerate",
                            "--matching-method", method, "--loader", "pil"] + common) == 0,
              f"cli.offline {method} failed")
        out["offline_s"][method] = time.perf_counter() - t0
    margv = [("ANNOY" if a == "HNSW" else a) for a in argv] + ["--loader", "pil"]
    svc = online.make_service(online.build_parser().parse_args(margv + ["--device", "cuda"]))
    check(type(svc.index).__name__ == "RPForestIndex", "cli.online ANNOY: not a forest")
    app = make_wsgi_app(svc)
    post(app, paths[15])                                     # warm-up
    posted = [post(app, p) for p in paths[:4]]
    ids = [[r["id"] for r in o["results"]] for o in posted]
    cpu = online.make_service(online.build_parser().parse_args(margv + ["--device", "cpu"]))
    t0 = time.perf_counter()
    cpu_ids = [[r["id"] for r in cpu.query_image(p)[0]] for p in paths[:4]]
    out["cpu_query_image_s"] = (time.perf_counter() - t0) / 4
    cpu.close()
    check(cpu_ids == ids, f"ANNOY: CPU service ids {cpu_ids}, card {ids}")
    out["annoy"] = {"search_s": [o["timing"]["search_s"] for o in posted],
                    "extract_s": [o["timing"]["extract_s"] for o in posted],
                    "rank0_own_image": sum(row[0] == i for i, row in enumerate(ids))}
    svc.close()
    print(f"matchers serving: {json.dumps(out)} ({card})", flush=True)
    return out


def regional_phase(paths, dev, card, n_cpu=2):
    """A regional (Rpool over GeM) and an R-MAC ResNet101-SOLAR at full width,
    seeded random weights, extract the 16 JPEGs one image at a time (1024
    px, three scales, no mask); ``n_cpu`` of them are held against the same
    nets on the CPU at 1e-4."""
    from image_search_engine_for_historical_research_tpu_torch.data.images import load_test_image
    from image_search_engine_for_historical_research_tpu_torch.models import init_network
    from image_search_engine_for_historical_research_tpu_torch.models.extract import (
        DEFAULT_SCALES,
        make_extract_fn,
    )

    images = [torch.from_numpy(load_test_image(p, 1024))[None] for p in paths]
    out = {}
    for name, params in (("regional gem", {"regional": True}), ("rmac", {"pooling": "rmac"})):
        net = init_network(params, seed=0, device=dev)
        fn = make_extract_fn(net.module, scales=DEFAULT_SCALES)
        fn(images[0].to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vecs = torch.cat([fn(im.to(dev)) for im in images]).cpu()
        secs = (time.perf_counter() - t0) / len(images)
        check(vecs.shape == (len(paths), 2048) and bool(torch.isfinite(vecs).all()),
              f"{name}: bad descriptors")
        check(bool(((vecs.norm(dim=1) - 1).abs() < 1e-4).all()), f"{name}: not unit norm")
        cpu_fn = make_extract_fn(init_network(params, seed=0, device="cpu").module,
                                 scales=DEFAULT_SCALES)
        err = max(float((cpu_fn(images[i]) - vecs[i:i + 1]).abs().max()) for i in range(n_cpu))
        check(err <= 1e-4, f"{name}: card vs CPU descriptor error {err} > 1e-4")
        out[name] = {"s_per_image": secs, "cpu_max_abs_err": err, "cpu_images": n_cpu,
                     "image_hw": list(images[0].shape[1:3])}
        print(f"regional {name}: {json.dumps(out[name])} ({card})", flush=True)
        del net
    return out


def large_n_phase(bs, dev, flush, card):
    """HNSW above the largest N whose visited bitset fits in shared memory: a
    random m0=32 table of 1,787,777 bf16 rows (one above that N at D=2048,
    ef=100; 7.3 GB). ``HNSWIndex.search`` launches the kernel once with the
    bitset in device memory; the kernel is held against its plain version on
    the same starts, and timed beside one row fewer (bitset in shared memory,
    without the row cache). A random graph does not promise that a query row
    is reachable from its start, so no rank is checked against the row."""
    from image_search_engine_for_historical_research_tpu_torch.index import HNSWIndex

    limit = 1_787_776
    n = limit + 1
    g = torch.Generator(device=dev).manual_seed(3)
    vecs = torch.empty((n, D), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 262144):
        blk = torch.randn((min(262144, n - s), D), device=dev, generator=g)
        vecs[s:s + blk.shape[0]] = blk / blk.norm(dim=1, keepdim=True)
    nbr0 = torch.randint(0, n - 1, (n, M0), device=dev, dtype=torch.int32, generator=g)
    nbru = torch.full((5, n, 16), -1, dtype=torch.int32, device=dev)
    coarse = torch.arange(0, n - 1, 4096, dtype=torch.int32, device=dev)
    pick = torch.randint(0, n - 1, (Q_BIG,), generator=g, device=dev)
    q = unit_rows(vecs[pick].float() + 0.5 * torch.randn(Q_BIG, D, generator=g, device=dev)
                  / D ** 0.5)
    big = HNSWIndex(vecs, nbr0, nbru, 0, EF, coarse)
    plans = {}
    for label, N in (("device_bitset", n), ("shared_bitset", limit)):
        cache, smem_visited, smem = bs.shared_memory_plan(N, D, M0, bs.padded_ef(EF))
        plans[label] = {"N": N, "cache": cache, "smem_visited": smem_visited, "smem": smem}
    check(plans["device_bitset"]["smem_visited"] == 0 and plans["device_bitset"]["cache"] == 1,
          f"N={n}: plan {plans['device_bitset']}")
    check(plans["shared_bitset"]["smem_visited"] == 1, f"N={limit}: plan {plans['shared_bitset']}")
    bs.launches = 0
    t0 = time.perf_counter()
    s4, i4 = big.search(q[:4], 10)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    check(bs.launches == 1, f"N={n}: {bs.launches} kernel launches, want 1")
    check(bool((i4 >= 0).all()) and bool(torch.isfinite(s4).all()), f"N={n}: bad results")
    starts = coarse_starts(big, q)
    _, i_k = bs.beam_search(vecs, nbr0, q[:4], starts[:4], ef=EF)
    check(torch.equal(i_k[:, :10], i4), f"N={n}: HNSWIndex.search differs from its kernel call")
    out = {"n": n, "plans": plans, "search_s_q4": search_s}
    for label, N in (("device_bitset", n), ("shared_bitset", limit)):
        rec = measure(bs, vecs[:N], nbr0[:N], q, starts, flush, tie=1e-3, reps=10)
        out[label] = rec
        print(f"beam_search at N={N} ({label}): {json.dumps(rec)} ({card})", flush=True)
    del vecs, nbr0, nbru, big
    torch.cuda.empty_cache()
    return out


def make_revisitop(root, n_scenes=32, views=7, seed=7):
    """A revisitop1m layout of ``n_scenes * (views + 1)`` synthetic scene
    photographs of 768 x 1024 px, the size of revisitop1m's distractors
    (``data.synthetic.make_scene_revisited``):
    ``<root>/revisitop1m/jpg/*.jpg`` and the image list
    ``<root>/revisitop1m/revisitop1m.txt``."""
    from image_search_engine_for_historical_research_tpu_torch.data.synthetic import (
        make_scene_revisited,
    )

    make_scene_revisited(root, dataset="revisitop1m", n_scenes=n_scenes, db_views=views,
                         canvas=(960, 1280), crop=(768, 1024), seed=seed)
    jpg = os.path.join(root, "revisitop1m", "jpg")
    with open(os.path.join(root, "revisitop1m", "revisitop1m.txt"), "w") as f:
        f.write("\n".join(sorted(os.listdir(jpg))))


def extract_1m_phase(data_root, ckpt, tmp, card):
    """``cli.extract_1m`` at full width (ResNet101-SOLAR, 1024 px, the CLI's
    three default scales, batch 16) over the revisitop1m layout, decoding
    with PIL: sharded (``--shard-size 128``) with ``--limit`` at half the
    images, then resumed to the end; one-shot; ``--bf16`` on the first half.
    The resumed shards equal the one-shot rows (1e-4); bf16 keeps a mean
    cosine >= 0.999 to them; ``build_pq(M=16, Ks=256)`` from ``chunked_feature_source``
    equals the in-memory build, array for array. (The native loader is not
    driven here: the card's machine has no libjpeg, ``PERF.md`` section 4.)"""
    from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m
    from image_search_engine_for_historical_research_tpu_torch.data import (
        chunked_feature_relpaths,
        chunked_feature_source,
        load_path_features,
        read_imlist,
        shard_resume_point,
    )
    from image_search_engine_for_historical_research_tpu_torch.index import build_pq

    names = read_imlist(os.path.join(data_root, "revisitop1m", "revisitop1m.txt"))
    n = len(names)
    base = ["--data-root", data_root, "--network-path", ckpt, "--device", "cuda",
            "--image-size", "1024", "--batch-size", "16", "--loader", "pil"]
    out = {"images": n, "runs": {}}

    def run(label, outputs, *extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        check(extract_1m.main(base + ["--outputs", outputs] + list(extra)) == 0,
              f"cli.extract_1m {label} failed")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = int(extra[extra.index("--limit") + 1]) if "--limit" in extra else n
        if label.endswith("resumed"):
            rows -= n // 2
        rec = {"images": rows, "s": secs, "img_per_s": rows / secs,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["runs"][label] = rec
        print(f"cli.extract_1m {label}: {json.dumps(rec)} ({card})", flush=True)

    sharded = os.path.join(tmp, "x1m_sharded")
    run("sharded, --limit half", sharded, "--shard-size", "128", "--limit", str(n // 2))
    check(shard_resume_point("revisitop1m", root=sharded) == n // 2, "resume point after --limit")
    run("sharded, resumed", sharded, "--shard-size", "128")
    check(shard_resume_point("revisitop1m", root=sharded) == n, "shards do not cover the images")
    check(chunked_feature_relpaths("revisitop1m", root=sharded) == names, "shard paths")
    chunks_fn, n_rows = chunked_feature_source("revisitop1m", root=sharded)
    resumed = np.concatenate(list(chunks_fn()))
    run("one-shot", os.path.join(tmp, "x1m_oneshot"))
    run("one-shot --bf16, --limit half", os.path.join(tmp, "x1m_bf16"), "--bf16",
        "--limit", str(n // 2))
    rows = {k: load_path_features("revisitop1m", root=os.path.join(tmp, d))[0]
            for k, d in (("f32", "x1m_oneshot"), ("bf16", "x1m_bf16"))}
    err = float(np.abs(resumed - rows["f32"]).max())
    cos_bf16 = np.sum(rows["bf16"] * rows["f32"][:n // 2], axis=1)
    out["checks"] = {"resumed_vs_oneshot_max_abs": err,
                     "bf16_cosine_mean": float(cos_bf16.mean()),
                     "bf16_cosine_min": float(cos_bf16.min())}
    check(n_rows == n and resumed.shape == (n, 2048) and np.isfinite(resumed).all(),
          "bad shard rows")
    check(err <= 1e-4, f"resumed shards vs one-shot: {err} > 1e-4")
    check(float(cos_bf16.mean()) >= 0.999, f"bf16 mean cosine {float(cos_bf16.mean())}")

    t0 = time.perf_counter()
    streamed = build_pq(chunks_fn, n=n_rows, M=16, Ks=256, device="cuda")
    stream_s = time.perf_counter() - t0
    mem = build_pq(resumed, M=16, Ks=256, device="cuda")
    a, b = streamed.to_arrays()[1], mem.to_arrays()[1]
    check(set(a) == set(b), f"streamed PQ arrays {sorted(a)} vs {sorted(b)}")
    for k in a:
        check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"streamed PQ array {k} differs")
    out["checks"]["streamed_build_pq_equal"] = sorted(a)
    out["checks"]["streamed_build_pq_s"] = stream_s
    print(f"extract_1m phase: {json.dumps(out)} ({card})", flush=True)
    return out


SAHA_DATASET = "roxford5k"   # the revisited gnd layout configdataset reads


def saha_layout(x1m_root, oneshot, root, outputs, n_scenes=32, views=7):
    """Lay the ``make_revisitop`` photographs out as a revisited dataset:
    one query a scene (``q_s<c>``), its ``views`` other views as the
    database (``db_s<c>_<i>``, scene-major; the first half easy, the rest
    hard, as ``make_scene_revisited`` splits them), under
    ``<root>/<SAHA_DATASET>`` (gnd pickle, ``jpg`` linked to the images);
    the extraction phase's one-shot rows of those images become the two
    feature stores under ``outputs``. Returns the image directory."""
    import pickle

    from image_search_engine_for_historical_research_tpu_torch.data import (
        load_path_features,
        save_path_feature,
    )

    rows, rel = load_path_features("revisitop1m", root=oneshot)
    by_name = {os.path.splitext(os.path.basename(r))[0]: i for i, r in enumerate(rel)}
    imlist = [f"db_s{c}_{i}" for c in range(n_scenes) for i in range(views)]
    qimlist = [f"q_s{c}" for c in range(n_scenes)]
    half = max(1, views // 2)
    gnd = [{"easy": np.arange(c * views, c * views + half),
            "hard": np.arange(c * views + half, (c + 1) * views),
            "junk": np.array([], np.int64), "bbx": [0, 0, 1024, 768]} for c in range(n_scenes)]
    d = os.path.join(root, SAHA_DATASET)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"gnd_{SAHA_DATASET}.pkl"), "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    jpg = os.path.join(x1m_root, "revisitop1m", "jpg")
    os.symlink(jpg, os.path.join(d, "jpg"))
    for name, names in ((SAHA_DATASET, imlist), (SAHA_DATASET + "_queries", qimlist)):
        save_path_feature(name, rows[[by_name[n] for n in names]],
                          [f"jpg/{n}.jpg" for n in names], root=outputs)
    return jpg


def sift_images(paths, size=(1000, 1000)):
    """Grayscale [0, 1] images at ``size`` as ``sift_extract_device`` reads them."""
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("L").resize(size), np.float32) / 255.0
                     for p in paths])


SAHA_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                              "saha_jax_reference.json")


def images_digest(jpg, names):
    """sha256 over the bytes of ``<jpg>/<name>.jpg`` in ``names``' order."""
    import hashlib

    h = hashlib.sha256()
    for n in names:
        with open(os.path.join(jpg, n + ".jpg"), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def saha_cpu_side(jpg, names, store, pairs, out):
    """Part of the CPU half of the SAHA phase's card-vs-CPU checks, run in a
    child process beside the card's work: the port's device SIFT on the CPU
    over ``names`` (1,024 keypoints, 4 octaves, one batch) or the AdaLAM
    counts of ``pairs`` ((query, candidate) names, features from
    ``store``), written to ``out`` (npz) with their seconds."""
    from image_search_engine_for_historical_research_tpu_torch.ops import sift
    from image_search_engine_for_historical_research_tpu_torch.rerank import geometric

    t0 = time.perf_counter()
    if names:
        res = sift.sift_program(torch.as_tensor(sift_images([os.path.join(jpg, n + ".jpg")
                                                             for n in names])),
                                4, sift.default_budgets(1024, 4))
        np.savez(out, s=time.perf_counter() - t0, **{k: v.numpy() for k, v in res.items()})
        return
    feats = {n: geometric.LocalFeatures.load(os.path.join(store, n + ".npz"))
             for n in {n for pair in pairs for n in pair}}
    counts = geometric.adalam_count_pairs([feats[q] for q, _ in pairs],
                                          [feats[c] for _, c in pairs], pair_batch=8,
                                          device="cpu")
    np.savez(out, s=time.perf_counter() - t0, counts=counts)


def start_cpu_child(fn, args, out, threads):
    """``chip_smoke.<fn>(*args, out)`` in a child process that sees no GPU,
    with ``threads`` CPU threads."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            f"chip_smoke.{fn}(*json.loads(sys.argv[2]))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(threads))
    return subprocess.Popen([sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__)),
                             json.dumps(list(args) + [out])], env=env)


def start_cpu_side(jpg, names, store, pairs, tmp, pair_batch=8):
    """``saha_cpu_side`` in child processes, one thread each (the CPU's
    AdaLAM and SIFT scale poorly with threads): one for the SIFT of
    ``names``, and one for each slice of whole ``pair_batch`` blocks of
    ``pairs``, as many as leave this process two cores. Returns the
    processes and their output files, the SIFT's first."""
    blocks = [pairs[i:i + pair_batch] for i in range(0, len(pairs), pair_batch)]
    k = max(1, min(len(blocks), (os.cpu_count() or 4) - 3))
    jobs = [(names, [])] + [([], [p for blk in blocks[i::k] for p in blk]) for i in range(k)]
    outs = [os.path.join(tmp, f"saha_cpu_side_{i}.npz") for i in range(len(jobs))]
    procs = [start_cpu_child("saha_cpu_side", [jpg, n, store, pr], out, 1)
             for (n, pr), out in zip(jobs, outs)]
    return procs, outs, jobs


def sift_agreement(card, cpu, tol_px=1e-2, tol_desc=1e-3):
    """Device SIFT fields of the same images from the card and the CPU: each
    valid card keypoint is matched to the CPU keypoint within ``tol_px``
    whose angle is nearest, and counts if their descriptors agree within
    ``tol_desc``. Returns the share of matched keypoints (of the larger
    valid count) and the worst gaps."""
    matched = total = 0
    worst_px = worst_desc = 0.0
    for b in range(len(card["valid"])):
        vc, vp = card["valid"][b], cpu["valid"][b]
        total += max(int(vc.sum()), int(vp.sum()))
        xy_p, ang_p, desc_p = cpu["xy"][b][vp], cpu["angle"][b][vp], cpu["desc"][b][vp]
        for i in np.nonzero(vc)[0]:
            gap = np.linalg.norm(xy_p - card["xy"][b][i], axis=1)
            near = np.nonzero(gap <= tol_px)[0]
            if not len(near):
                continue
            da = np.abs((ang_p[near] - card["angle"][b][i] + np.pi) % (2 * np.pi) - np.pi)
            j = near[int(np.argmin(da))]
            dgap = float(np.abs(desc_p[j] - card["desc"][b][i]).max())
            worst_px = max(worst_px, float(gap[j]))
            worst_desc = max(worst_desc, dgap)
            matched += dgap <= tol_desc
    return {"images": len(card["valid"]), "valid_card": int(card["valid"].sum()),
            "valid_cpu": int(cpu["valid"].sum()), "matched_share": matched / max(total, 1),
            "worst_px": worst_px, "worst_desc": worst_desc}


def saha_against_jax(cfg, jpg, ranks, counts, b):
    """The card's SAHA re-rank held against the JAX package's on the same
    photographs and shortlist, ``SAHA_REFERENCE`` (written by
    ``scripts/saha_jax_witness.py``: the JAX package's device SIFT and
    AdaLAM on the CPU over a shortlist this phase wrote): the images' digest
    is the reference's; every shortlisted pair has a JAX count; at most 2%
    of the pairs' counts differ from JAX's, each by at most ``max(1, 10%)``
    of JAX's count (a DoG value that ties its neighbour in one package and
    not in the other adds or drops a keypoint, and AdaLAM's inlier counts
    move with it: 4 of 960 pairs, by 1-3 of 1-37, ``PERF.md`` section 5);
    mapE/M/H of the re-rank by the card's counts within 0.005 of the re-rank
    by JAX's over the same ranks."""
    from image_search_engine_for_historical_research_tpu_torch.evaluation import (
        compute_map_revisited,
    )
    from image_search_engine_for_historical_research_tpu_torch.rerank import rerank_by_inliers

    with open(SAHA_REFERENCE) as f:
        ref = json.load(f)
    check(images_digest(jpg, cfg["qimlist"] + cfg["imlist"]) == ref["images_sha256"],
          "the SAHA photographs differ from those the JAX reference was taken on")
    check(ref["b"] == b, f"the JAX reference re-ranks the top {ref['b']}, this run {b}")
    jax_counts = np.array([[ref["counts"].get(q, {}).get(cfg["imlist"][int(j)], -1)
                            for j in ranks[qi, :b]] for qi, q in enumerate(cfg["qimlist"])])
    missing = int((jax_counts < 0).sum())
    check(missing == 0, f"{missing} shortlisted pairs have no JAX count: the HNSW shortlist "
                        f"is not the one {SAHA_REFERENCE} was taken on")
    differ = np.argwhere(counts != jax_counts)
    gap = np.abs(counts - jax_counts)
    rec = {"pairs": int(counts.size), "differ": [
               {"query": cfg["qimlist"][qi], "db": cfg["imlist"][int(ranks[qi, j])],
                "card": int(counts[qi, j]), "jax": int(jax_counts[qi, j])} for qi, j in differ],
           "max_gap": int(gap.max())}
    for label, c in (("card", counts), ("jax", jax_counts)):
        r = compute_map_revisited(rerank_by_inliers(ranks, c, b), cfg["gnd"], SAHA_DATASET)
        rec[f"map_{label}_counts"] = {"E": r.mapE, "M": r.mapM, "H": r.mapH}
    check(len(differ) <= 0.02 * counts.size
          and bool((gap <= np.maximum(1, np.ceil(0.1 * jax_counts))).all()),
          f"AdaLAM counts: {len(differ)} of {counts.size} shortlisted pairs differ from the "
          f"JAX package's: {rec['differ']}")
    for k in "EMH":
        check(abs(rec["map_card_counts"][k] - rec["map_jax_counts"][k]) <= 0.005,
              f"map{k} after sift: {rec['map_card_counts'][k]} with the card's counts, "
              f"{rec['map_jax_counts'][k]} with JAX's")
    return rec


def write_saha_shortlist(cfg, jpg, ranks, counts, maps, b):
    """``scripts/saha_shortlist.json`` (not committed): what
    ``scripts/saha_jax_witness.py`` re-ranks with the JAX package (the
    layout's names and gnd, the baseline ranks, the card's counts of the
    top-``b`` pairs, the mAPs)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                           "saha_shortlist.json"), "w") as f:
        json.dump({"images_sha256": images_digest(jpg, cfg["qimlist"] + cfg["imlist"]),
                   "b": b, "qimlist": cfg["qimlist"], "imlist": cfg["imlist"],
                   "gnd": [{k: np.asarray(g[k]).tolist() for k in ("easy", "hard", "junk")}
                           for g in cfg["gnd"]],
                   "ranks": np.asarray(ranks).tolist(), "counts": counts.tolist(),
                   "map": maps}, f)


def saha_phase(x1m_root, oneshot, tmp, flush, card, n_check=4, b=30):
    """SAHA geometric verification at the JAX defaults (device SIFT at
    1000 x 1000, 1,024 keypoints, 4 octaves; AdaLAM's DEFAULT_CONFIG; b=30,
    pair_batch=8, dispatch scan) through ``cli.test_reranking --methods sift
    --sift-backend device --matching-method HNSW`` over ``saha_layout``'s
    dataset (32 queries, 224 views), with the features kept in a store.
    Checks: K1 launched by the HNSW matcher; the shortlist's AdaLAM counts
    against the JAX package's (``saha_against_jax``); the device SIFT of 8
    images on the card against the CPU (at least 99% of the valid keypoints
    within 1e-2 px, descriptors within 1e-3); AdaLAM counts of ``n_check``
    queries x ``b`` candidates (each query's own views, then other scenes')
    from the stored features, card against CPU (at most 2% of the pairs
    differ, by at most 1) and the banked pair batches against the per-pair
    verifier (equal). The CPU halves run in child processes beside the
    card's work. mAP E/M/H before and after are printed: half the views are
    mirrored and SIFT is not mirror-invariant, and the JAX package's re-rank
    lowers mapM on these photographs too (``PERF.md`` section 5), so mapM
    is held to JAX's, not to the baseline."""
    from image_search_engine_for_historical_research_tpu_torch import rerank
    from image_search_engine_for_historical_research_tpu_torch.cli import test_reranking
    from image_search_engine_for_historical_research_tpu_torch.data import configdataset
    from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
    from image_search_engine_for_historical_research_tpu_torch.ops import sift
    from image_search_engine_for_historical_research_tpu_torch.rerank import geometric

    root, outputs = os.path.join(tmp, "saha_data"), os.path.join(tmp, "saha_out")
    jpg = saha_layout(x1m_root, oneshot, root, outputs)
    cfg = configdataset(SAHA_DATASET, root)
    store = os.path.join(tmp, "saha_sift")
    spent = {k: [0.0, 0] for k in ("sift_extract_device", "adalam_count_pairs", "sift_rerank")}
    seen = {}
    saved = {}

    def timer(mod, name):
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += len(a[0])
            seen[name] = (a, res)
            return res

        setattr(mod, name, timed)

    argv = ["--dataset", SAHA_DATASET, "--data-root", root, "--outputs", outputs,
            "--matching-method", "HNSW", "--methods", "sift", "--sift-backend", "device",
            "--sift-store", store, "--device", "cuda"]
    for mod, name in ((geometric, "sift_extract_device"), (geometric, "adalam_count_pairs"),
                      (rerank, "sift_rerank")):
        timer(mod, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bs.launches = 0
    t0 = time.perf_counter()
    try:
        res = test_reranking.run(test_reranking.build_parser().parse_args(argv))
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    out = {"cli_s": time.perf_counter() - t0, "k1_launches": bs.launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "map": {k: {"E": r.mapE, "M": r.mapM, "H": r.mapH} for k, r in res.items()}}
    (sift_s, n_img), (ada_s, n_pairs), (rr_s, _) = (spent[k] for k in (
        "sift_extract_device", "adalam_count_pairs", "sift_rerank"))
    out.update(sift_images=n_img, sift_s=sift_s, sift_img_per_s=n_img / sift_s,
               adalam_pairs=n_pairs, adalam_s=ada_s, adalam_pairs_per_s=n_pairs / ada_s,
               rerank_s=rr_s)
    print(f"SAHA cli.test_reranking --methods sift: {json.dumps(out)} ({card})", flush=True)
    check(out["k1_launches"] > 0, "the HNSW matcher of the SAHA run did not launch K1")
    check(n_pairs == 32 * b, f"SAHA verified {n_pairs} pairs, want {32 * b}")
    ranks = np.asarray(seen["sift_rerank"][0][2])
    counts = np.asarray(seen["adalam_count_pairs"][1]).reshape(len(ranks), b)
    write_saha_shortlist(cfg, jpg, ranks, counts, out["map"], b)

    # the card-vs-CPU checks: 8 images' SIFT, and n_check queries x b pairs
    sift_names = ["q_s0"] + [f"db_s0_{i}" for i in range(7)]
    pairs = [(f"q_s{c}", n) for c in range(n_check) for n in [f"db_s{c}_{i}" for i in range(7)]
             + [f"db_s{(c + 1 + k // 7) % 32}_{k % 7}" for k in range(b - 7)]]
    # the re-rank extracted only its queries' shortlists: add what the check needs
    geometric.sift_offline([os.path.join(jpg, n + ".jpg") for n in
                            sorted({n for pair in pairs for n in pair})], store,
                           backend="device", device="cuda")
    children, cpu_outs, jobs = start_cpu_side(jpg, sift_names, store, pairs, tmp)
    try:
        out["jax_reference"] = saha_against_jax(cfg, jpg, ranks, counts, b)
        print(f"SAHA against the JAX package: {json.dumps(out['jax_reference'])} ({card})",
              flush=True)
        budgets = sift.default_budgets(1024, 4)
        sift_card = {k: v.cpu().numpy() for k, v in sift.sift_program(torch.as_tensor(
            sift_images([os.path.join(jpg, n + ".jpg") for n in sift_names]), device="cuda"),
            4, budgets).items()}
        feats = {n: geometric.LocalFeatures.load(os.path.join(store, n + ".npz"))
                 for n in {n for pair in pairs for n in pair}}
        fq, fc = [feats[q] for q, _ in pairs], [feats[c] for _, c in pairs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ada_card = geometric.adalam_count_pairs(fq, fc, pair_batch=8, device="cuda")
        card_s = time.perf_counter() - t0
        verify = geometric.make_adalam_verifier(device="cuda")
        per_pair = [verify(x, y) for x, y in zip(fq, fc)]
        check(per_pair == ada_card.tolist(), "AdaLAM: banked pair batches and the per-pair "
                                             "verifier give different counts on the card")
        out["ops"] = saha_ops(jpg, fq, fc, flush, card)
        for c in children:
            check(c.wait() == 0, f"a SAHA CPU-side process exited with {c.returncode}")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    cpu = dict(np.load(cpu_outs[0]))
    out["sift_card_vs_cpu"] = sift_agreement(sift_card, cpu)
    out["sift_card_vs_cpu"]["cpu_s"] = float(cpu["s"])
    print(f"SAHA SIFT card vs CPU: {json.dumps(out['sift_card_vs_cpu'])} ({card})", flush=True)
    check(out["sift_card_vs_cpu"]["matched_share"] >= 0.99,
          f"device SIFT: card and CPU keypoints agree on "
          f"{out['sift_card_vs_cpu']['matched_share']:.4f} < 0.99")
    parts = [dict(np.load(f)) for f in cpu_outs[1:]]
    by_pair = {p: int(c) for (_, pr), part in zip(jobs[1:], parts)
               for p, c in zip(map(tuple, pr), part["counts"])}
    ada_cpu = np.array([by_pair[p] for p in pairs])
    diff = np.nonzero(ada_card != ada_cpu)[0]
    ada = {"pairs": len(pairs), "card_s": card_s, "card_pairs_per_s": len(pairs) / card_s,
           "cpu_s": max(float(part["s"]) for part in parts), "cpu_processes": len(parts),
           "differ": [{"pair": pairs[i], "card": int(ada_card[i]), "cpu": int(ada_cpu[i])}
                      for i in diff],
           "max_gap": int(np.abs(ada_card - ada_cpu).max()),
           "own_view_counts": [ada_card[c * b:c * b + 7].tolist() for c in range(n_check)]}
    out["adalam_card_vs_cpu"] = ada
    print(f"SAHA AdaLAM card vs CPU: {json.dumps(ada)} ({card})", flush=True)
    check(len(diff) <= 0.02 * len(pairs) and ada["max_gap"] <= 1,
          f"AdaLAM counts: {len(diff)} of {len(pairs)} pairs differ between card "
          f"and CPU, by up to {ada['max_gap']}")
    return out


def saha_ops(jpg, fq, fc, flush, card):
    """The device parts of SAHA timed alone (median CUDA events, L2 flushed):
    ``sift_program`` on 8 of the images already on the card (no host
    decode), its descriptor pass on one octave's patches, one AdaLAM RANSAC
    block (``_count_inliers`` over (8 pairs, 16 iterations, 256 seeds, 256
    members)), and one banked-scan block of 8 pairs, with a trace of the
    last (idle share, top kernels)."""
    from image_search_engine_for_historical_research_tpu_torch.ops import sift
    from image_search_engine_for_historical_research_tpu_torch.rerank import adalam, geometric

    names = sorted(os.listdir(jpg))[:8]
    imgs = torch.as_tensor(sift_images([os.path.join(jpg, n) for n in names]), device="cuda")
    budgets = sift.default_budgets(1024, 4)
    out = {"sift_program_b8_ms": time_ms(lambda: sift.sift_program(imgs, 4, budgets), 3, flush)}
    g = torch.Generator(device="cuda").manual_seed(0)
    patches = torch.rand((8 * budgets[0], sift.PATCH, sift.PATCH), device="cuda", generator=g)
    theta = torch.rand(patches.shape[0], device="cuda", generator=g) * 6.28
    sig = 1.6 + torch.rand(patches.shape[0], device="cuda", generator=g) * 3
    out["descriptor_pass_ms"] = time_ms(lambda: sift._descriptor(patches, theta, sig), 5, flush)
    res = torch.rand((8, adalam.BLOCK, 256, 256), device="cuda", generator=g) * 1e-2
    member = torch.rand((8, 1, 256, 256), device="cuda", generator=g) < 0.3
    out["ransac_block_ms"] = time_ms(lambda: adalam._count_inliers(res, member, 200.0), 10,
                                     flush)
    pair_ms = time_ms(lambda: geometric.adalam_count_pairs(fq[:8], fc[:8], device="cuda"), 5,
                      flush)
    out["adalam_8_pairs_ms"] = pair_ms
    out["adalam_8_pairs_trace"] = trace_op(
        lambda: geometric.adalam_count_pairs(fq[:8], fc[:8], device="cuda"))
    print(f"SAHA device ops: {json.dumps(out)} ({card})", flush=True)
    return out


def opq_fit_phase(card):
    """The refine OPQ fit of ``scripts/measure_torch_opq_fit.py`` (M=32,
    Ks=256, 10 rounds over 4,112 residual rows) split into its parts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "measure_torch_opq_fit",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                     "measure_torch_opq_fit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = mod.measure(rows=4112, reps=1)
    print(f"refine OPQ fit split: {json.dumps(rec)}", flush=True)
    return rec


# the ladder of scripts/measure_train_kr.py: (label, frozen_stages, compute_dtype, remat, tuples)
TRAIN_RUNGS = (
    ("unfrozen", 0, None, False, 5),
    ("frozen", 3, None, False, 5),
    ("frozen+bf16", 3, torch.bfloat16, False, 5),
    ("frozen+bf16+remat", 3, torch.bfloat16, True, 5),
    ("frozen+bf16+remat x2 tuples", 3, torch.bfloat16, True, 10),
)
TRAIN_S, TRAIN_PX = 7, 362


def _train_batch(n_tuples, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((n_tuples * TRAIN_S, TRAIN_PX, TRAIN_PX, 3), device=dev, generator=g)
    labels = torch.tensor([-1, 1] + [0] * (TRAIN_S - 2), dtype=torch.int32,
                          device=dev).repeat(n_tuples)
    return images, labels


def _grads(module, images, labels):
    from image_search_engine_for_historical_research_tpu_torch.train import make_loss_fn

    module.zero_grad(set_to_none=True)
    loss = make_loss_fn(module, TRAIN_S, "contrastive", 0.7, lambda_sos=10.0)(images, labels)
    loss.backward()
    return loss.detach(), {n: None if p.grad is None else p.grad.detach().clone()
                           for n, p in module.named_parameters()}


def train_phase(online, ckpt, data_root, argv, tmp, dev, card):
    """Training at full width: ResNet101-SOLAR from the served checkpoint,
    contrastive + SOS (lambda 10), AdamW lr 1e-6 wd 1e-6, 7-image tuples at
    362 px. One frozen step on the card against the CPU: in f64 the loss and
    every gradient element, in f32 (TF32 off) the loss and every gradient
    leaf in norm, against rtol 1e-3 or 4x the leaf's spread under a 1e-7
    nudge of the input; the ladder of ``scripts/measure_train_kr.py``
    (s/step, img/s, peak memory, FLOPs a step from ``FlopCounterMode``,
    ``mfu``); remat's
    gradients against the step without it; then ``cli.train`` end to end (2
    epochs with a held-out eval set, and the same run stopped after epoch 0
    and resumed, with deterministic cuDNN: equal epoch-1 losses), and one
    POST served from the trained checkpoint."""
    from torch.utils.flop_counter import FlopCounterMode

    from image_search_engine_for_historical_research_tpu_torch.cli import train as cli_train
    from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
    from image_search_engine_for_historical_research_tpu_torch.data.synthetic import (
        make_folder_dataset,
    )
    from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app
    from image_search_engine_for_historical_research_tpu_torch.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    out = {"card_vs_cpu": {}, "ladder": {}}
    frozen_prefixes = ("features.conv1.", "features.conv2_x.", "features.conv3_x.",
                       "features.conv4_x.")

    # one frozen step, 1 tuple x 7 images, on the card and on the CPU. In
    # f64 (backbone and head; the weights are f32) every gradient is held
    # element by element at rtol 1e-3 + atol 1e-6. In f32 (TF32 off) the
    # loss is held at rtol 1e-4, and each gradient leaf in norm: within
    # rtol 1e-3 (atol 1e-6 an element), or, where the step is too ill
    # conditioned for that, within 4x the leaf's own spread when the input
    # moves by a relative 1e-7, the larger of the card's and the CPU's. The
    # served weights are random, so the SOA softmax is nearly one-hot and a
    # 1e-7 nudge moves some leaves by percents on either device
    model = load_network(ckpt, device=dev)
    model.module.requires_grad_(True)
    cpu = load_network(ckpt, device="cpu")
    cpu.module.requires_grad_(True)
    images, labels = _train_batch(1, dev, seed=1)
    nudged = images.cpu() * (1 + 1e-7 * torch.randn(images.shape,
                                                    generator=torch.Generator().manual_seed(5)))
    runs = {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        runs["gpu", dtype] = _grads(model.module.clone(frozen_stages=3, compute_dtype=dtype),
                                    images, labels)
        runs["cpu", dtype] = _grads(cpu.module.clone(frozen_stages=3, compute_dtype=dtype),
                                    images.cpu(), labels.cpu())
    runs["gpu nudged", torch.float32] = _grads(model.module.clone(frozen_stages=3),
                                               nudged.to(dev), labels)
    runs["cpu nudged", torch.float32] = _grads(cpu.module.clone(frozen_stages=3), nudged,
                                               labels.cpu())
    steps_s = time.perf_counter() - t0
    del cpu
    rec = {"steps_s": steps_s}
    trainable = [n for n, g in runs["cpu", torch.float64][1].items() if g is not None]
    check(sorted(set(runs["cpu", torch.float64][1]) - set(trainable))
          == sorted(n for n in runs["cpu", torch.float64][1] if n.startswith(frozen_prefixes)),
          "frozen step: the stem and conv2_x-conv4_x must have no gradient, the rest one")

    def diff(a, b, n):
        """``(||a - b||, ||b||)`` of leaf ``n``, in f64 on the host."""
        ga, gb = runs[a][1][n].cpu().double(), runs[b][1][n].cpu().double()
        return float((ga - gb).norm()), float(gb.norm())

    def rel(a, b, n):
        """``||a - b|| / ||b||``, the norm floored at an atol of 1e-6 an
        element (leaves whose exact gradient is nearly zero)."""
        d, ref = diff(a, b, n)
        return d / max(ref, 1e-6 * runs[b][1][n].numel() ** 0.5)

    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        (l_gpu, g_gpu), (l_cpu, _) = runs["gpu", dtype], runs["cpu", dtype]
        check(sorted(n for n, g in g_gpu.items() if g is not None) == sorted(trainable),
              f"frozen step ({tag}): the card's gradients are on other parameters")
        check(abs(float(l_gpu) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu)),
              f"frozen step ({tag}) loss: card {float(l_gpu)} CPU {float(l_cpu)}")
        rec[tag] = {"loss_gpu": float(l_gpu), "loss_cpu": float(l_cpu),
                    "params_without_grad": len(g_gpu) - len(trainable),
                    "grad_norm_rel_max": max(rel(("gpu", dtype), ("cpu", dtype), n)
                                             for n in trainable)}
    g64, c64 = runs["gpu", torch.float64][1], runs["cpu", torch.float64][1]
    worst = max((float(((g64[n].cpu() - c64[n]).abs() - (1e-6 + 1e-3 * c64[n].abs())).max()), n)
                for n in trainable)
    rec["f64"]["grad_worst_excess"] = worst[0]
    check(worst[0] <= 0, f"frozen step (f64) gradient {worst[1]} off by {worst[0]} beyond "
                         "rtol 1e-3 + atol 1e-6")
    f32 = torch.float32
    leaves = []
    for n in trainable:
        d, ref = diff(("gpu", f32), ("cpu", f32), n)
        spread = max(rel(("gpu nudged", f32), ("gpu", f32), n),
                     rel(("cpu nudged", f32), ("cpu", f32), n))
        atol = 1e-6 * runs["cpu", f32][1][n].numel() ** 0.5
        leaves.append((d / (atol + max(1e-3, 4 * spread) * ref), n, d <= atol + 1e-3 * ref))
    worst32 = max(leaves)
    rec["f32"].update({
        "gpu_nudged_grad_norm_rel_max": max(rel(("gpu nudged", f32), ("gpu", f32), n)
                                            for n in trainable),
        "cpu_nudged_grad_norm_rel_max": max(rel(("cpu nudged", f32), ("cpu", f32), n)
                                            for n in trainable),
        "gpu_vs_cpu_f64_norm_rel_max": max(rel(("gpu", f32), ("cpu", torch.float64), n)
                                           for n in trainable),
        "cpu_vs_cpu_f64_norm_rel_max": max(rel(("cpu", f32), ("cpu", torch.float64), n)
                                           for n in trainable),
        "leaves_within_rtol_1e-3": sum(ok for *_, ok in leaves), "leaves": len(leaves),
        "worst_share_of_limit": worst32[0], "worst_leaf": worst32[1]})
    check(worst32[0] <= 1.0, f"frozen step (f32) gradient {worst32[1]} at {worst32[0]:.3f} of "
                             "its limit (rtol 1e-3, or 4x its spread under a 1e-7 nudge)")
    out["card_vs_cpu"] = rec
    del runs, g64, c64
    print(f"train card vs CPU: {json.dumps(out['card_vs_cpu'])} ({card})", flush=True)

    # the ladder
    module = model.module
    for label, frozen, dtype, remat, tuples in TRAIN_RUNGS:
        opt, sched, _ = make_optimizer(module, lr=1e-6, weight_decay=1e-6, exp_decay=0.0,
                                       freeze_backbone=frozen > 0)
        state = init_train_state(module, opt, sched)
        step = make_train_step(module.clone(frozen_stages=frozen, compute_dtype=dtype,
                                            remat=remat), TRAIN_S, lambda_sos=10.0)
        images, labels = _train_batch(tuples, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            state, loss = step(state, images, labels)
        times = []
        for _ in range(10):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = step(state, images, labels)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with FlopCounterMode(display=False) as fc:
            state, loss = step(state, images, labels)
        flops = fc.get_total_flops()
        s = statistics.median(times)
        peak_rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        rec = {"tuples": tuples, "images": tuples * TRAIN_S, "px": TRAIN_PX,
               "s_per_step": s, "img_per_s": tuples * TRAIN_S / s, "peak_gib": peak,
               "tflop_per_step": flops / 1e12, "mfu": flops / s / peak_rate,
               "peak_tflops": peak_rate / 1e12, "loss": float(loss)}
        check(bool(torch.isfinite(loss)), f"{label}: loss {float(loss)}")
        out["ladder"][label] = rec
        print(f"train rung {label}: {json.dumps(rec)} ({card})", flush=True)
        del opt, sched, state, step
    module.zero_grad(set_to_none=True)

    # remat against the same step without it
    images, labels = _train_batch(5, dev, seed=2)
    peaks = {}
    res = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res[remat] = _grads(module.clone(frozen_stages=3, compute_dtype=torch.bfloat16,
                                         remat=remat), images, labels)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
    (l0, g0), (l1, g1) = res[False], res[True]
    check(abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0)), f"remat loss {l1} vs {l0}")
    rerr = max(float(((g1[n] - g0[n]).abs() - 1e-5 * g0[n].abs()).max())
               for n in g0 if g0[n] is not None)
    check(rerr <= 0, f"remat gradients differ beyond rtol 1e-5 (excess {rerr})")
    check(peaks[True] <= peaks[False], f"remat peak {peaks[True]} GiB above {peaks[False]}")
    out["remat"] = {"loss": float(l0), "grad_excess": rerr, "peak_gib": peaks[True],
                    "peak_gib_without": peaks[False]}
    module.zero_grad(set_to_none=True)
    del model, res, g0, g1
    torch.cuda.empty_cache()

    # cli.train end to end, then resumed, with deterministic cuDNN
    train_root, eval_root = os.path.join(tmp, "train_data"), os.path.join(tmp, "eval_data")
    make_folder_dataset(train_root, n_classes=16, per_class=6, n_queries_per_class=0,
                        size=(288, 384), seed=3)
    make_folder_dataset(eval_root, n_classes=8, per_class=4, n_queries_per_class=0,
                        size=(288, 384), seed=4)
    common = ["--training-dataset", os.path.join(train_root, "db"), "--network-path", ckpt,
              "--sos", "--image-size", str(TRAIN_PX), "--query-size", "32",
              "--test-datasets", os.path.join(eval_root, "db"), "--device", "cuda"]
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for label, argv_run in (
                ("2 epochs", [os.path.join(tmp, "runs_full"), "--epochs", "2"]),
                ("epoch 0", [os.path.join(tmp, "runs_resume"), "--epochs", "1"]),
                ("resumed", [os.path.join(tmp, "runs_resume"), "--epochs", "2", "--resume"])):
            t0 = time.perf_counter()
            check(cli_train.main(argv_run + common) == 0, f"cli.train {label} failed")
            runs[label] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    name = cli_train.run_name(cli_train.build_parser().parse_args(
        [os.path.join(tmp, "runs_full")] + common))
    logs = {}
    for d in ("runs_full", "runs_resume"):
        with open(os.path.join(tmp, d, name, "metrics.jsonl")) as f:
            logs[d] = [json.loads(line) for line in f]
    full, resumed = logs["runs_full"], logs["runs_resume"]
    check([r["step"] for r in full] == [0, 1] == [r["step"] for r in resumed],
          f"epochs logged: {[r['step'] for r in full]} / {[r['step'] for r in resumed]}")
    a, b = np.asarray(full[1]["step_losses"]), np.asarray(resumed[1]["step_losses"])
    check(a.shape == b.shape and a.size > 0 and np.allclose(b, a, rtol=1e-4, atol=0),
          f"resumed epoch-1 losses {b.tolist()} vs uninterrupted {a.tolist()}")
    eval_keys = sorted(k for k in full[1] if k.endswith("/mapM"))
    check(eval_keys and all(0.0 <= full[e][k] <= 1.0 + 1e-9 for e in (0, 1) for k in eval_keys),
          f"eval rows {eval_keys}")
    out["cli_train"] = {"run_s": runs, "steps_per_epoch": len(full[0]["step_losses"]),
                        "train_loss": [r["train_loss"] for r in full],
                        "val_loss": [r["val_loss"] for r in full],
                        "eval_mapM": [r[eval_keys[0]] for r in full],
                        "resumed_epoch1_max_rel": float(np.max(np.abs(b - a) / np.abs(a)))}
    print(f"cli.train: {json.dumps(out['cli_train'])} ({card})", flush=True)

    # serve one POST from the trained checkpoint
    trained = os.path.join(tmp, "runs_full", name, "epoch_1.pth")
    targv = [a for a in argv]
    targv[targv.index("--network-path") + 1] = trained
    svc = online.make_service(online.build_parser().parse_args(targv + ["--device", "cuda"]))
    res = post(make_wsgi_app(svc), os.path.join(data_root, "images", "img00.jpg"))
    svc.close()
    ids = [r["id"] for r in res["results"]]
    check(len(ids) == 10, f"trained checkpoint served {ids}")
    out["served_post"] = {"ids": ids, "timing": res["timing"]}
    print(f"train phase: {json.dumps(out)} ({card})", flush=True)
    return out


# ------------------------------------------------ slice 10: LoFTR and D2-Net

LOFTR_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                               "loftr_jax_reference.json")
LOFTR_SEED = 0                 # the seeded random weights of the LoFTR and D2-Net phases
LOFTR_RES = (640, 480)         # the CLI's resolution (w, h)
D2NET_HELD = (512, 384)        # the photographs held against the CPU and JAX (w, h): a depth cut
D2NET_PROJ = 8                 # descriptor projections the JAX reference keeps a keypoint
D2NET_HELD_NAMES = ("q_s0", "q_s1")


def loftr_witness_pairs(n_queries=4, n_other=8):
    """The (query, view) names held against the JAX package: each of the
    first ``n_queries`` scenes' query against its 7 own views and
    ``n_other`` views of other scenes, keyed by name (a moved HNSW
    shortlist cannot stale them)."""
    pairs = []
    for c in range(n_queries):
        pairs += [(f"q_s{c}", f"db_s{c}_{i}") for i in range(7)]
        pairs += [(f"q_s{c}", f"db_s{(c + 1 + k) % 32}_{k % 7}") for k in range(n_other)]
    return pairs


def loftr_images(jpg, names, resolution=LOFTR_RES):
    """(n, h, w, 1) grayscale in [0, 1], read as ``loftr_rerank`` reads them
    (OpenCV)."""
    import cv2

    w, h = resolution
    return np.stack([cv2.resize(cv2.imread(os.path.join(jpg, n + ".jpg"), cv2.IMREAD_GRAYSCALE),
                                (w, h)).astype(np.float32)[..., None] / 255.0 for n in names])


def d2net_image(path, size=D2NET_HELD):
    """RGB in [0, 1], (h, w, 3) f32 at ``size`` (PIL bilinear)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB").resize(size, Image.BILINEAR),
                      np.float32) / 255.0


def arrays_digest(arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def state_digest(module):
    """sha256 over a module's ``state_dict`` (key order, f32 bytes)."""
    sd = module.state_dict()
    return arrays_digest(sd[k].detach().cpu().numpy() for k in sorted(sd))


def d2net_summary(kpts, scores, desc, n_full=16):
    """What the JAX reference keeps of a pyramid: every keypoint and score,
    each descriptor's projections on ``D2NET_PROJ`` seeded unit directions,
    and ``n_full`` evenly spaced whole descriptors."""
    dirs = np.random.default_rng(0).standard_normal((desc.shape[1], D2NET_PROJ))
    dirs /= np.linalg.norm(dirs, axis=0)
    full = np.linspace(0, len(desc) - 1, min(n_full, len(desc))).astype(int)
    return {"kpts": kpts.tolist(), "scores": scores.tolist(),
            "proj": (desc.astype(np.float64) @ dirs).tolist(), "full_idx": full.tolist(),
            "full": desc[full].tolist()}


def d2net_agreement(got, ref, tol_px=1e-2, tol_desc=1e-4, tol_proj=1e-3, tol_score=1e-5):
    """A pyramid ``got`` (kpts, scores, desc) against a reference pyramid or
    ``d2net_summary``: each reference keypoint is matched to ``got``'s
    nearest keypoint of the same scale within ``tol_px``; the keypoints on
    one side only are the knife edges (``hard_detection``'s exact
    equalities). Over the matched ones: the worst position gap, score gap
    relative to the largest score, and descriptor gaps (whole rows where
    the reference keeps them, projections elsewhere)."""
    if not isinstance(ref, dict):
        ref = d2net_summary(*ref, n_full=len(ref[0]))
    k, s, d = got
    rk, rs = np.asarray(ref["kpts"]), np.asarray(ref["scores"])
    dirs = np.random.default_rng(0).standard_normal((d.shape[1], D2NET_PROJ))
    dirs /= np.linalg.norm(dirs, axis=0)
    proj = d.astype(np.float64) @ dirs
    full = dict(zip(ref["full_idx"], np.asarray(ref["full"])))
    match, worst = {}, {"px": 0.0, "score": 0.0, "desc": 0.0, "proj": 0.0}
    top = max(float(np.abs(rs).max()) if len(rs) else 1.0, 1e-30)
    for i, p in enumerate(rk):
        same = np.nonzero(k[:, 2] == p[2])[0]
        if not len(same):
            continue
        gap = np.abs(k[same, :2] - p[:2]).max(1)
        j = same[int(np.argmin(gap))]
        if gap.min() > tol_px or j in match.values():
            continue
        match[i] = j
        worst["px"] = max(worst["px"], float(gap.min()))
        worst["score"] = max(worst["score"], abs(float(s[j]) - float(rs[i])) / top)
        worst["proj"] = max(worst["proj"], float(np.abs(proj[j] - ref["proj"][i]).max()))
        if i in full:
            worst["desc"] = max(worst["desc"], float(np.abs(d[j] - full[i]).max()))
    rec = {"ref": len(rk), "got": len(k), "matched": len(match),
           "knife_edges": len(rk) + len(k) - 2 * len(match), "worst": worst}
    rec["ok"] = bool(rec["knife_edges"] <= 0.01 * max(len(rk), 1) and len(match) > 0
                     and worst["px"] <= tol_px and worst["score"] <= tol_score
                     and worst["desc"] <= tol_desc and worst["proj"] <= tol_proj)
    return rec


D2NET_PAIRS = [("q_s0", "db_s0_0"), ("q_s0", "db_s0_1"), ("q_s0", "db_s1_0"),
               ("q_s0", "db_s1_1"), ("q_s1", "db_s1_0"), ("q_s1", "db_s1_1"),
               ("q_s1", "db_s0_0"), ("q_s1", "db_s0_1")]


def loftr_cpu_side(jpg, pairs, out):
    """The CPU half of the LoFTR card-vs-CPU check, in a child process: the
    port's counts of ``pairs`` (one batch) at thr 0.2 and 0.0 with the
    seeded weights, and the row maxima of the first pair's confidence
    matrix, written to ``out`` (npz) with their seconds."""
    from image_search_engine_for_historical_research_tpu_torch.models import loftr

    t0 = time.perf_counter()
    q, c = (loftr_images(jpg, [p[i] for p in pairs]) for i in (0, 1))
    res = {}
    for thr in (0.2, 0.0):
        m = loftr.init_matcher(seed=LOFTR_SEED, device="cpu", thr=thr)
        res[f"counts_{thr}"] = loftr.make_batched_count_fn(m)(q, c).numpy()
    with torch.inference_mode():
        _, conf = m(torch.from_numpy(q[:1]), torch.from_numpy(c[:1]), fine=False,
                    return_conf=True)
    np.savez(out, s=time.perf_counter() - t0, row_max=conf[0].amax(1).numpy(), **res)


def d2net_cpu_side(jpg, held, pairs, out):
    """The CPU half of the D2-Net checks, in a child process: the port's
    pyramids of the ``held`` photographs at ``D2NET_HELD`` and the AdaLAM
    counts of ``pairs`` from features extracted on the CPU, to ``out``."""
    from image_search_engine_for_historical_research_tpu_torch.models import d2net
    from image_search_engine_for_historical_research_tpu_torch.rerank import geometric

    t0 = time.perf_counter()
    m = d2net.init_d2net(seed=LOFTR_SEED, device="cpu")
    res = {}
    for i, n in enumerate(held):
        res[f"k{i}"], res[f"s{i}"], res[f"d{i}"] = d2net.process_multiscale(
            d2net_image(os.path.join(jpg, n + ".jpg")), m)
    feats = {n: d2net.extract_d2net_features(m, d2net_image(os.path.join(jpg, n + ".jpg")))
             for n in sorted({n for p in pairs for n in p})}
    res["counts"] = geometric.adalam_count_pairs([feats[q] for q, _ in pairs],
                                                 [feats[c] for _, c in pairs], device="cpu")
    np.savez(out, s=time.perf_counter() - t0, **res)


def wait_child(proc, label):
    check(proc.wait() == 0, f"the {label} CPU-side process exited with {proc.returncode}")


def counts_against(got, want, label):
    """Counts held to a reference: at most 2% of the pairs differ, each by
    at most max(1, 10% of the reference's count)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = np.abs(got - want)
    differ = np.nonzero(gap)[0]
    rec = {"pairs": len(want), "differ": len(differ), "max_gap": int(gap.max()),
           "nonzero": int((want > 0).sum()), "distinct": len(set(want.tolist())),
           "gaps": [(int(i), int(got[i]), int(want[i])) for i in differ]}
    check(len(differ) <= 0.02 * len(want)
          and bool((gap <= np.maximum(1, np.ceil(0.1 * want))).all()),
          f"{label}: {len(differ)} of {len(want)} counts differ: {rec['gaps']}")
    return rec


def loftr_phase(tmp, flush, card, child, b=60):
    """The LoFTR re-rank at full width: the default ``LoFTRConfig`` (d 256,
    8 coarse layers), 480 x 640, the seeded weights written as a
    released-layout file (``{"state_dict": {"matcher.*"}}``).
    (a) ``cli.test_reranking --methods loftr --matching-method HNSW
    --loftr-ckpt`` over ``saha_layout``'s dataset at the CLI's settings
    (b=60, pair_batch 4: 1,920 pairs): seconds, pairs/s, peak memory, mAP
    before and after, the count histogram, K1's launches; the CLI's counts
    of the pairs the JAX reference holds. (b) The ``loftr_witness_pairs``
    through ``loftr_rerank`` with the batched driver at thr 0.2 and 0.0,
    against ``LOFTR_REFERENCE`` (``counts_against``), and the row maxima of
    2 pairs' confidence matrices within 1e-3 of JAX's (bf16's gap printed
    beside them). (c) ``child``'s CPU
    counts of the first 4 pairs at both thresholds equal the card's, and the
    row maxima within 1e-3. (d) Per-pair, batched and banked counts of 16
    pairs equal. (e) bf16 counts beside f32's. Then one block of 4 pairs
    timed alone (count path and full forward) with its FLOPs and a trace."""
    from torch.utils.flop_counter import FlopCounterMode

    from image_search_engine_for_historical_research_tpu_torch import rerank
    from image_search_engine_for_historical_research_tpu_torch.cli import test_reranking
    from image_search_engine_for_historical_research_tpu_torch.data import configdataset
    from image_search_engine_for_historical_research_tpu_torch.models import loftr
    from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs

    root, outputs = os.path.join(tmp, "saha_data"), os.path.join(tmp, "saha_out")
    jpg = os.path.join(root, SAHA_DATASET, "jpg")
    with open(LOFTR_REFERENCE) as f:
        ref = json.load(f)
    pairs = [tuple(p) for p in ref["pairs"]]
    check(pairs == loftr_witness_pairs(), "the JAX reference holds other pairs")
    names = sorted({n for p in pairs for n in p})
    check(images_digest(jpg, names) == ref["images_sha256"],
          "the LoFTR photographs differ from those the JAX reference was taken on")
    host = loftr.init_matcher(seed=LOFTR_SEED, device="cpu")
    check(state_digest(host) == ref["weights_sha256"],
          "the seeded LoFTR weights differ from those the JAX reference was taken on")
    ckpt = os.path.join(tmp, "loftr_seeded_outdoor_layout.ckpt")
    torch.save({"state_dict": {"matcher." + k: v for k, v in host.state_dict().items()}}, ckpt)
    del host
    out = {"decoded_images_equal": arrays_digest(loftr_images(jpg, names))
           == ref["decoded_sha256"], "seconds": {}}
    clock = [time.perf_counter()]

    def lap(label):
        torch.cuda.synchronize()
        out["seconds"][label] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()

    # (a) the CLI
    made, spent = [], {}
    make, rr = loftr.make_batched_count_fn, rerank.loftr_rerank

    def recording_make(matcher, compute_dtype=None):
        fn = make(matcher, compute_dtype)

        def counted(a, c):
            made.append(fn(a, c))
            return made[-1]

        return counted

    def timed_rr(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = rr(*a, **kw)
        torch.cuda.synchronize()
        spent["s"], spent["ranks"] = time.perf_counter() - t0, np.asarray(a[2])
        return r

    argv = ["--dataset", SAHA_DATASET, "--data-root", root, "--outputs", outputs,
            "--matching-method", "HNSW", "--methods", "loftr", "--device", "cuda",
            "--loftr-ckpt", ckpt]
    loftr.make_batched_count_fn, rerank.loftr_rerank = recording_make, timed_rr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bs.launches = 0
    t0 = time.perf_counter()
    try:
        res = test_reranking.run(test_reranking.build_parser().parse_args(argv))
    finally:
        loftr.make_batched_count_fn, rerank.loftr_rerank = make, rr
    torch.cuda.synchronize()
    counts = torch.cat(made).cpu().numpy()
    Q = len(spent["ranks"])
    out["cli"] = {"cli_s": time.perf_counter() - t0, "rerank_s": spent["s"],
                  "pairs": int(len(counts)), "pairs_per_s": len(counts) / spent["s"],
                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "k1_launches": bs.launches,
                  "map": {k: {"E": r.mapE, "M": r.mapM, "H": r.mapH} for k, r in res.items()},
                  "count_histogram": {int(v): int(n) for v, n in
                                      zip(*np.unique(counts, return_counts=True))}}
    check(len(counts) == Q * b == 32 * b, f"the CLI counted {len(counts)} pairs, want {32 * b}")
    check(bs.launches > 0, "the HNSW matcher of the LoFTR run did not launch K1")
    cfg = configdataset(SAHA_DATASET, root)
    imlist, qimlist = cfg["imlist"], cfg["qimlist"]
    in_ref = {p: i for i, p in enumerate(pairs)}
    overlap = [(int(counts[qi * b + j]), ref["counts"]["0.2"][in_ref[(qimlist[qi], imlist[d])]])
               for qi in range(Q) for j, d in enumerate(spent["ranks"][qi, :b])
               if (qimlist[qi], imlist[d]) in in_ref]
    out["cli"]["vs_jax"] = counts_against([g for g, _ in overlap], [w for _, w in overlap],
                                          "the CLI's counts of the reference's pairs") \
        if overlap else {"pairs": 0}
    print(f"LoFTR cli.test_reranking --methods loftr: {json.dumps(out['cli'])} ({card})",
          flush=True)
    lap("setup_and_cli")

    # (b) the witness pairs through loftr_rerank, both thresholds
    qn = sorted({q for q, _ in pairs})
    dn = sorted({d for _, d in pairs})
    wr = np.array([[dn.index(d) for q2, d in pairs if q2 == q] for q in qn])
    models = {thr: loftr.load_loftr_checkpoint(ckpt, loftr.LoFTRConfig(thr=thr), device="cuda")
              for thr in (0.2, 0.0)}

    def witness_counts(m, compute_dtype=None):
        got, fn = [], loftr.make_batched_count_fn(m, compute_dtype)
        rerank.loftr_rerank([os.path.join(jpg, n + ".jpg") for n in qn],
                            [os.path.join(jpg, n + ".jpg") for n in dn], wr,
                            count_fn=lambda a, c: got.append(fn(a, c)) or got[-1],
                            b=wr.shape[1], resolution=LOFTR_RES, pair_batch=4)
        return torch.cat(got).cpu().numpy()[:len(pairs)]

    card_counts = {thr: witness_counts(m) for thr, m in models.items()}
    out["witness"] = {str(thr): counts_against(card_counts[thr], ref["counts"][str(thr)],
                                               f"LoFTR counts at thr {thr} against JAX")
                      for thr in (0.2, 0.0)}
    out["witness"]["non_vacuous"] = [str(thr) for thr in (0.2, 0.0)
                                     if out["witness"][str(thr)]["distinct"] > 1]
    check(out["witness"]["non_vacuous"], "the witness counts are constant at both thresholds")
    q_imgs = loftr_images(jpg, [q for q, _ in pairs])
    c_imgs = loftr_images(jpg, [c for _, c in pairs])
    row_gap = {}          # f32, held; bf16, printed beside it as the limit's upper reading
    for dtype, key, i in ((d, k, i) for d in (torch.float32, torch.bfloat16)
                          for k, i in (("own", 0), ("other", 7))):
        with torch.inference_mode():
            _, conf = models[0.0](*(torch.as_tensor(x[i:i + 1], device="cuda").to(dtype)
                                    for x in (q_imgs, c_imgs)), fine=False, return_conf=True)
        got = conf[0].amax(1).cpu().numpy()
        want = np.asarray(ref["row_max"][key])
        row_gap[key if dtype == torch.float32 else key + "_bf16"] = float(
            (np.abs(got - want) / want).max())
    out["witness"]["row_max_rel_gap"] = row_gap
    check(max(row_gap["own"], row_gap["other"]) <= 1e-3,
          f"conf row maxima against JAX: {row_gap}")
    lap("witness")

    # (d) the three drivers on 16 pairs (blocks of 4, the CLI's shapes), (e) bf16
    m0 = models[0.0]
    per_pair = [int(loftr.make_match_fn(m0)(q_imgs[i], c_imgs[i]).num_matches) for i in range(16)]
    count = loftr.make_batched_count_fn(m0)
    batched = torch.cat([count(q_imgs[i:i + 4], c_imgs[i:i + 4]) for i in range(0, 16, 4)])
    bank = np.concatenate([q_imgs[:16], c_imgs[:16]])
    banked = loftr.make_banked_count_fn(m0)(bank, np.arange(16).reshape(4, 4),
                                            np.arange(16, 32).reshape(4, 4))
    out["drivers"] = {"per_pair": per_pair, "batched": batched.tolist(),
                      "banked": banked.reshape(-1).tolist()}
    check(per_pair == out["drivers"]["batched"] == out["drivers"]["banked"],
          f"LoFTR drivers disagree on the card: {out['drivers']}")
    got = witness_counts(m0, torch.bfloat16)          # (at thr 0.2 every count is 0)
    out["bf16"] = {"thr": 0.0, "counts": got.tolist(), "f32": card_counts[0.0].tolist(),
                   "differ": int((got != card_counts[0.0]).sum())}
    lap("drivers_bf16")

    # one block of 4 pairs alone: the count path, the full forward, bf16
    blk = [torch.as_tensor(x[:4], device="cuda") for x in (q_imgs, c_imgs)]
    with torch.inference_mode():
        with FlopCounterMode(display=False) as fc:
            m0(*blk, fine=False)
        flops_count = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            m0(*blk)
        flops_full = fc.get_total_flops()
        imgs8 = torch.cat(blk).permute(0, 3, 1, 2)
        ops = {"count_block_ms": time_ms(lambda: m0(*blk, fine=False), 5, flush),
               "backbone_coarse_8_images_ms": time_ms(lambda: m0.backbone(imgs8, fine=False),
                                                      5, flush),
               "full_block_ms": time_ms(lambda: m0(*blk), 5, flush),
               "bf16_count_block_ms": time_ms(lambda: m0(*(x.bfloat16() for x in blk),
                                                         fine=False), 5, flush),
               "tflop_per_pair_count": flops_count / 4e12,
               "tflop_per_pair_full": flops_full / 4e12}
        ops["count_block_f32_peak_share"] = flops_count / (ops["count_block_ms"] / 1e3) / F32_FLOPS
        ops["backbone_share_of_count_block"] = (ops["backbone_coarse_8_images_ms"]
                                                / ops["count_block_ms"])
        ops["count_block_trace"] = trace_op(lambda: m0(*blk, fine=False))
    out["ops"] = ops
    lap("ops")
    print(f"LoFTR witness, drivers, bf16, ops: "
          f"{json.dumps({k: out[k] for k in ('witness', 'drivers', 'bf16', 'ops')})} ({card})",
          flush=True)

    # (c) the CPU side
    wait_child(child[0], "LoFTR")
    lap("wait_cpu")
    cpu = dict(np.load(child[1]))
    out["card_vs_cpu"] = {"pairs": 4, "cpu_s": float(cpu["s"])}
    for thr in (0.2, 0.0):
        got, want = card_counts[thr][:4], cpu[f"counts_{thr}"]
        out["card_vs_cpu"][str(thr)] = {"card": got.tolist(), "cpu": want.tolist()}
        check(np.array_equal(got, want), f"LoFTR card vs CPU at thr {thr}: {got} vs {want}")
    with torch.inference_mode():
        _, conf = m0(*(torch.as_tensor(x[:1], device="cuda") for x in (q_imgs, c_imgs)),
                     fine=False, return_conf=True)
    gap = float((np.abs(conf[0].amax(1).cpu().numpy() - cpu["row_max"]) / cpu["row_max"]).max())
    out["card_vs_cpu"]["row_max_rel_gap"] = gap
    check(gap <= 1e-3, f"LoFTR conf row maxima card vs CPU: {gap}")
    print(f"LoFTR card vs CPU: {json.dumps(out['card_vs_cpu'])} ({card})", flush=True)
    return out


LOFTR_TRAIN_RUNGS = (   # scripts/measure_loftr_train.py's ladder: label, dtype, remat, accum
    ("f32", None, False, None),
    ("bf16+remat", torch.bfloat16, True, None),
    ("bf16+remat+accum2", torch.bfloat16, True, 2),
)
LOFTR_TRAIN_SMALL = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16,
                         nhead=4, coarse_layers=("self", "cross"), thr=0.0, max_matches=24)


def loftr_train_phase(tmp, card, batch=4, steps=10):
    """``make_loftr_train_step`` at 480 x 640 (the default config, seeded
    weights, AdamW at the JAX defaults) on batches of ``batch`` pairs: four
    query photographs and their ``random_homography`` warps (jitter 0.1, as
    ``scripts/measure_loftr_train.py``). Each rung of the ladder (f32; bf16
    + remat; bf16 + remat + ``accum=2``): 2 warm-up steps then the median of
    CUDA-event steps, pairs/s, peak memory, FLOPs a step from
    ``FlopCounterMode`` and ``mfu`` against 67 TFLOP/s f32 or 989 TFLOP/s
    bf16. The f32 rung takes ``steps`` steps: the BN statistics must not
    move, and its losses are printed. Then one step at JAX's small test
    config (32 x 48, 4 pairs) in f64 on the card and on the CPU: the loss
    within 1e-6 and every gradient leaf within 1e-4 of its norm."""
    from torch.utils.flop_counter import FlopCounterMode

    from image_search_engine_for_historical_research_tpu_torch.models import loftr
    from image_search_engine_for_historical_research_tpu_torch.train import (
        init_loftr_train_state,
        make_loftr_optimizer,
        make_loftr_train_step,
        random_homography,
    )

    jpg = os.path.join(tmp, "saha_data", SAHA_DATASET, "jpg")
    imgs = torch.as_tensor(loftr_images(jpg, [f"q_s{c}" for c in range(batch)]), device="cuda")
    rng = np.random.default_rng(0)
    Hs = torch.as_tensor(np.stack([random_homography(rng, 480, 640, jitter=0.1)
                                   for _ in range(batch)]), device="cuda")
    out = {"pairs": batch, "hw": [480, 640], "ladder": {}}
    for label, dtype, remat, accum in LOFTR_TRAIN_RUNGS:
        m = loftr.init_matcher(seed=LOFTR_SEED, device="cuda", remat=remat)
        stats = {k: v.clone() for k, v in m.named_buffers()}
        state = init_loftr_train_state(m, *make_loftr_optimizer(m))
        step = make_loftr_train_step(compute_dtype=dtype, accum=accum)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        n = steps if label == "f32" else 7
        for i in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = step(state, imgs, Hs)
            e1.record()
            torch.cuda.synchronize()
            losses.append(float(loss))
            if i >= 2:
                times.append(e0.elapsed_time(e1) / 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        frozen = all(torch.equal(v, stats[k]) for k, v in m.named_buffers())
        with FlopCounterMode(display=False) as fc:
            step(state, imgs, Hs)
        s = statistics.median(times)
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        rec = {"s_per_step": s, "pairs_per_s": batch / s, "peak_gib": peak,
               "tflop_per_step": fc.get_total_flops() / 1e12,
               "mfu": fc.get_total_flops() / s / rate, "peak_tflops": rate / 1e12,
               "steps": n, "losses": losses, "bn_statistics_unchanged": frozen}
        out["ladder"][label] = rec
        print(f"LoFTR train rung {label}: {json.dumps(rec)} ({card})", flush=True)
        check(np.isfinite(losses).all(), f"LoFTR train {label}: losses {losses}")
        check(frozen, f"LoFTR train {label}: the frozen BN statistics moved")
        del m, state, step
    torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    small = rng.uniform(0, 1, (4, 32, 48, 1))
    small_h = np.stack([random_homography(rng, 32, 48, jitter=0.05) for _ in range(4)])
    runs = {}
    for dev in ("cpu", "cuda"):
        m = loftr.init_matcher(seed=LOFTR_SEED, device=dev, **LOFTR_TRAIN_SMALL).double()
        state = init_loftr_train_state(m, *make_loftr_optimizer(m))
        _, loss = make_loftr_train_step()(state, torch.as_tensor(small, device=dev),
                                          torch.as_tensor(small_h, device=dev))
        runs[dev] = float(loss), {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
    gaps = {k: float((runs["cuda"][1][k] - g).norm() / g.norm().clamp(min=1e-300))
            for k, g in runs["cpu"][1].items()}
    worst = max(gaps, key=gaps.get)
    out["f64_card_vs_cpu"] = {"loss_card": runs["cuda"][0], "loss_cpu": runs["cpu"][0],
                              "leaves": len(gaps), "worst_leaf": worst,
                              "worst_rel_norm_gap": gaps[worst]}
    print(f"LoFTR train f64 card vs CPU: {json.dumps(out['f64_card_vs_cpu'])} ({card})",
          flush=True)
    check(abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-6 * abs(runs["cpu"][0]),
          f"LoFTR f64 step loss: card {runs['cuda'][0]}, CPU {runs['cpu'][0]}")
    check(gaps[worst] <= 1e-4, f"LoFTR f64 step gradient {worst}: {gaps[worst]}")
    return out


def d2net_phase(tmp, card, child, n_full=8, full=(1024, 768)):
    """D2-Net with seeded weights: ``process_multiscale`` (scales 0.5, 1, 2)
    on ``n_full`` photographs at 768 x 1024 (s an image, peak memory); the
    ``held`` two at ``D2NET_HELD`` against the JAX reference and against the
    port's CPU run (``d2net_agreement``: keypoints the same but at knife
    edges, at most 1% of them; positions within 1e-2 px: the sub-pixel step
    divides by small Hessian determinants and the half scale's positions are
    scaled by 8, so the port's CPU run and JAX's differ by up to 1.8e-3 px;
    scores within 1e-5 of the largest, descriptors within 1e-4);
    ``extract_d2net_features`` ->
    ``adalam_count_pairs`` over ``D2NET_PAIRS``: the card's counts equal the
    CPU's (features extracted there)."""
    from image_search_engine_for_historical_research_tpu_torch.models import d2net
    from image_search_engine_for_historical_research_tpu_torch.rerank import geometric

    jpg = os.path.join(tmp, "saha_data", SAHA_DATASET, "jpg")
    with open(LOFTR_REFERENCE) as f:
        ref = json.load(f)["d2net"]
    m = d2net.init_d2net(seed=LOFTR_SEED, device="cuda")
    check(state_digest(m) == ref["weights_sha256"],
          "the seeded D2-Net weights differ from those the JAX reference was taken on")
    out = {}
    names = [f"q_s{c}" for c in range(n_full)]
    imgs = [d2net_image(os.path.join(jpg, n + ".jpg"), full) for n in names]
    d2net.process_multiscale(imgs[0], m)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, kept = [], []
    for img in imgs:
        t0 = time.perf_counter()
        k, _, _ = d2net.process_multiscale(img, m)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        kept.append(len(k))
    out["full"] = {"images": n_full, "hw": [full[1], full[0]], "s_per_image": statistics.median(times),
                   "s": times, "keypoints": kept,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"D2-Net process_multiscale at full size: {json.dumps(out['full'])} ({card})", flush=True)
    check(min(kept) > 0, f"D2-Net kept {kept} keypoints")

    held = list(D2NET_HELD_NAMES)
    check(ref["held"] == held, f"the JAX reference holds {ref['held']}")
    check(images_digest(jpg, held) == ref["images_sha256"], "D2-Net photographs differ")
    pyr = [d2net.process_multiscale(d2net_image(os.path.join(jpg, n + ".jpg")), m) for n in held]
    out["vs_jax"] = [d2net_agreement(p, ref["pyramids"][n]) for p, n in zip(pyr, held)]
    print(f"D2-Net card vs JAX: {json.dumps(out['vs_jax'])} ({card})", flush=True)
    check(all(r["ok"] for r in out["vs_jax"]), f"D2-Net card vs JAX: {out['vs_jax']}")
    feats = {n: d2net.extract_d2net_features(m, d2net_image(os.path.join(jpg, n + ".jpg")))
             for n in sorted({n for p in D2NET_PAIRS for n in p})}
    counts = geometric.adalam_count_pairs([feats[q] for q, _ in D2NET_PAIRS],
                                          [feats[c] for _, c in D2NET_PAIRS], device="cuda")
    wait_child(child[0], "D2-Net")
    cpu = dict(np.load(child[1]))
    out["vs_cpu"] = [d2net_agreement(p, (cpu[f"k{i}"], cpu[f"s{i}"], cpu[f"d{i}"]))
                     for i, p in enumerate(pyr)]
    out["adalam"] = {"pairs": D2NET_PAIRS, "card": counts.tolist(),
                     "cpu": cpu["counts"].tolist(), "cpu_s": float(cpu["s"])}
    print(f"D2-Net card vs CPU: {json.dumps({k: out[k] for k in ('vs_cpu', 'adalam')})} "
          f"({card})", flush=True)
    check(all(r["ok"] for r in out["vs_cpu"]), f"D2-Net card vs CPU: {out['vs_cpu']}")
    check(np.array_equal(counts, cpu["counts"]), f"D2-Net AdaLAM counts: {out['adalam']}")
    return out


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
    phase_s = {}

    def timed(name, fn, *args):
        """Run one phase, keeping its wall seconds for the ``phase_s`` line."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

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
    kres = timed("kernel", kernel_phase, bs, beam_search_cases, dev, flush)

    # 3. a device-built HNSW graph at 1M, then diffusion on its rows
    graph_rec, big = timed("graph", graph_phase, bs, dev, flush, card)
    diff_1m = timed("diffusion_1m", diffusion_1m_phase, big[:DIFFUSION_ROWS], dev, flush, card)
    torch.cuda.empty_cache()

    # the refine OPQ fit split into its parts, then the PQ family at 1M on
    # the same rows, determinism and streaming
    opq_fit = timed("opq_fit", opq_fit_phase, card)
    pq_rec = timed("pq_1m", pq_1m_phase, big, dev, flush, card)
    pq_rec["determinism"] = timed("pq_determinism", pq_determinism_phase, big, dev, card)

    # the remaining matchers on the same rows, then HNSW above the kernel's N limit
    match_rec = timed("matchers_1m", matchers_1m_phase, big, dev, flush, card)
    del big
    torch.cuda.empty_cache()
    match_rec["large_n"] = timed("large_n", large_n_phase, bs, dev, flush, card)

    # 4. the global re-rankers at rParis6k's shape, and k-reciprocal at 100k
    rr = timed("rerank", rerank_phase, dev, flush, card)
    kr_large = timed("kr_100k", kr_large_phase, dev, card)

    # 5. the main path through the entry points (6. the CLIs on stored features)
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

        pq_rec["serving"] = timed("pq_serving", pq_serving_phase, offline, online, common, argv,
                                  paths, dev, card)
        match_rec["serving"] = timed("matchers_serving", matchers_serving_phase, offline, online,
                                     common, argv, paths, card)
        match_rec["regional"] = timed("regional", regional_phase, paths, dev, card)

        # slice 7: extraction at scale and training (no K1 path)
        bs.launches = 0
        timed("revisitop_layout", make_revisitop, os.path.join(tmp, "x1m_data"))
        slice7 = {"extract_1m": timed("extract_1m", extract_1m_phase,
                                     os.path.join(tmp, "x1m_data"), ckpt, tmp, card)}
        slice7["train"] = timed("train", train_phase, online, ckpt, data_root, argv_l2, tmp, dev,
                                card)
        torch.cuda.synchronize()
        check(bs.launches == 0, f"the slice-7 phases launched the beam kernel {bs.launches} times")
        torch.cuda.empty_cache()

        # slice 9: SAHA geometric verification over the extraction phase's images and rows
        saha = timed("saha", saha_phase, os.path.join(tmp, "x1m_data"),
                     os.path.join(tmp, "x1m_oneshot"), tmp, flush, card)
        torch.cuda.empty_cache()

        # slice 10: LoFTR and D2-Net over the SAHA layout's photographs, the
        # CPU halves of their checks in child processes beside the card's work
        jpg10 = os.path.join(tmp, "saha_data", SAHA_DATASET, "jpg")
        outs10 = [os.path.join(tmp, f"{k}_cpu_side.npz") for k in ("loftr", "d2net")]
        children = [(start_cpu_child("loftr_cpu_side", [jpg10, loftr_witness_pairs()[:4]],
                                     outs10[0], 3), outs10[0]),
                    (start_cpu_child("d2net_cpu_side", [jpg10, list(D2NET_HELD_NAMES),
                                                        D2NET_PAIRS], outs10[1], 3), outs10[1])]
        try:
            slice10 = {"loftr": timed("loftr", loftr_phase, tmp, flush, card, children[0])}
            slice10["loftr_train"] = timed("loftr_train", loftr_train_phase, tmp, card)
            slice10["d2net"] = timed("d2net", d2net_phase, tmp, card, children[1])
        finally:
            for proc, _ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        torch.cuda.empty_cache()

        d_launches, coalesce_rec = served_rerank_phase(
            bs, svc, lambda: online.make_service(online.build_parser().parse_args(
                argv + ["--device", "cpu"])), gallery, paths, tmp, data_root, dev, card)
        cli_rec = timed("clis", cli_phase, rr, tmp, paths, ckpt, dev, card)

        # 7. the kernel at the served shapes: Q=1 (a POST) and Q=32 (the largest slot)
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
              + [match_rec["large_n"][k]["max_abs_err"] for k in ("device_bitset", "shared_bitset")]
              + [r["max_abs_err"] for r in served])
    main_rec = served[0]
    print(json.dumps({"kernels": [{
        "name": "beam_search",
        "route": "cuda",
        "source": "image_search_engine_for_historical_research_tpu_torch/csrc/beam_search.cu",
        "replaces": "image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:354",
        "launches": (launches + d_launches + coalesce_rec["beam_launches"] + saha["k1_launches"]
                     + slice10["loftr"]["cli"]["k1_launches"]),
        "max_abs_err": err,
        "ms": main_rec["ms"],
        "device_ms": main_rec["device_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
        "us_per_hop": main_rec["us_per_hop"],
    }]}))
    print(json.dumps({"rerank": {"diffusion_6k": rr["diffusion"], "aqe": rr["aqe"],
                                 "dba": rr["dba"], "kr_6k": rr["kr"], "kr_100k": kr_large,
                                 "diffusion_1m": diff_1m, "coalescing": coalesce_rec,
                                 "clis": cli_rec}}))
    pq_rec["refine_opq_fit"] = opq_fit
    print(json.dumps({"pq": pq_rec}))
    print(json.dumps({"matchers": match_rec}))
    print(json.dumps({"slice7": slice7}))
    print(json.dumps({"saha": saha}))
    print(json.dumps({"slice10": slice10}))
    print(json.dumps({"phase_s": phase_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
