#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py

Drives ``image_search_engine_for_historical_research_tpu_torch`` on the card:

1. Environment: versions, the card's name and power limit, the kernels'
   build from the sources in this checkout (``nvcc`` and ``g++``, started
   together), TF32 off for matmuls and cuDNN.
2. The HNSW beam-search kernel against its plain PyTorch version on the card:
   ragged N=203 x 2048 with -1 padding and repeated ids, then N=1,000,000 x
   2048 (f32 and bf16) with a random m0=32 neighbour table, Q=70, ef=100.
3. The main path through the entry points a user calls: 16 synthetic JPEGs
   through ResNet101-SOLAR at full width (seeded, perturbed weights carried in
   as Flax-layout numpy arrays through ``from_flax_variables``, saved as a
   SOLAR checkpoint), 1024 px, three scales; a gallery of those 16 plus 4,096
   clustered descriptors; ``build_hnsw`` + ``save_index``;
   ``cli.online.make_service``; 4 WSGI POSTs, the same 4 images and 4 more
   through ``query_image``, and one ``query_batch`` of 4. The kernel's launch
   count is set to 0 just before and read just after; every search must have
   launched it. One query on a CPU-built service must give the card's ids.
4. Kernel and plain times at the served shapes (Q=1 and Q=32).

Prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it does so too without a
CUDA device.
"""

import io
import json
import os
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


def compare_beams(s_ref, i_ref, s_got, i_got, atol, tie):
    """Same id set per row, same distance per id (``atol``), and where the
    order differs the distances at those ranks within ``tie``. Returns the
    largest distance difference."""
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
            check(np.abs(s_ref[r][moved] - s_got[r][moved]).max() <= tie,
                  f"beam row {r}: order differs beyond ties")
    check(err <= atol, f"kernel vs plain distance error {err} > {atol}")
    return err


def time_ms(fn, reps, flush):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up,
    with the L2 cache flushed before each run (a served query finds it cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush()
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


def measure(bs, db, nbr0, q, starts, flush, reps=20, plain_reps=3):
    """Kernel vs plain on one input: error, times, this run's work."""
    s_k, i_k = bs.beam_search(db, nbr0, q, starts, ef=EF)
    torch.cuda.synchronize()
    stats = {}
    s_p, i_p = bs.beam_search_reference(db, nbr0, q, starts, ef=EF, stats=stats)
    err = compare_beams(s_p, i_p, s_k, i_k, atol=1e-3, tie=1e-3)
    ms = time_ms(lambda: bs.beam_search(db, nbr0, q, starts, ef=EF), reps, flush)
    plain = time_ms(lambda: bs.beam_search_reference(db, nbr0, q, starts, ef=EF),
                    plain_reps, flush)
    elt = db.element_size()
    bnd, by, nbytes = bound_ms(stats, q.shape[0], db.shape[1], elt,
                               bs.padded_ef(EF), nbr0.shape[1])
    return {"N": db.shape[0], "D": db.shape[1], "dtype": str(db.dtype).split(".")[-1],
            "Q": q.shape[0], "ef": EF, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "bytes": nbytes, "max_abs_err": err,
            "expansions_per_query": stats["expansions"] / q.shape[0],
            "fresh_rows_per_query": stats["fresh_rows"] / q.shape[0]}


def random_table(n, m0, g, dev):
    """Random neighbour table with ragged -1 tails and a repeated id per row."""
    nbr = torch.randint(0, n, (n, m0), generator=g, device=dev, dtype=torch.int32)
    tail = torch.randint(0, m0 // 4, (n, 1), generator=g, device=dev)
    nbr[torch.arange(m0, device=dev)[None, :] >= m0 - tail] = -1
    nbr[:, 9] = nbr[:, 2]
    return nbr


def unit_rows(x):
    return x / x.norm(dim=1, keepdim=True)


def kernel_phase(bs, dev, flush):
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    # (a) ragged N with padding and repeats, at the tests' tolerance
    db = unit_rows(torch.randn(203, D, generator=g, device=dev))
    nbr = random_table(203, M0, g, dev)
    q = unit_rows(torch.randn(8, D, generator=g, device=dev))
    starts = torch.randint(0, 203, (8,), generator=g, device=dev, dtype=torch.int32)
    s_k, i_k = bs.beam_search(db, nbr, q, starts, ef=EF)
    s_p, i_p = bs.beam_search_reference(db, nbr, q, starts, ef=EF)
    out["n203"] = compare_beams(s_p, i_p, s_k, i_k, atol=1e-4, tie=1e-5)
    print(f"kernel vs plain, N=203 D={D} f32 Q=8: max_abs_err {out['n203']}", flush=True)
    # (b) 1M x 2048, generated on the card
    db = unit_rows(torch.randn(N_BIG, D, generator=g, device=dev))
    nbr = random_table(N_BIG, M0, g, dev)
    pick = torch.randint(0, N_BIG, (Q_BIG,), generator=g, device=dev)
    q = unit_rows(db[pick] + 0.5 * torch.randn(Q_BIG, D, generator=g, device=dev) / D ** 0.5)
    starts = torch.randint(0, N_BIG, (Q_BIG,), generator=g, device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        rec = measure(bs, db.to(dtype).contiguous(), nbr, q, starts, flush, plain_reps=3)
        out[f"1m_{rec['dtype']}"] = rec
        print("beam_search at 1M:", json.dumps(rec), flush=True)
    del db, nbr
    torch.cuda.empty_cache()
    return out


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
    from image_search_engine_for_historical_research_tpu_torch.cli import online
    from image_search_engine_for_historical_research_tpu_torch.data import save_path_feature
    from image_search_engine_for_historical_research_tpu_torch.index import (
        build_hnsw,
        save_index,
    )
    from image_search_engine_for_historical_research_tpu_torch.models import (
        DEFAULT_SCALES,
        extract_vectors,
        from_flax_variables,
        init_network,
        to_flax_variables,
    )
    from image_search_engine_for_historical_research_tpu_torch.ops import beam_search as bs
    from image_search_engine_for_historical_research_tpu_torch.serving import make_wsgi_app

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card}", flush=True)

    # 1. build every kernel and native library, all compilers started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for f in [pool.submit(native.load, name) for name in ("beam_search", "hnsw")]:
            f.result()
    print(f"build_s {time.perf_counter() - t0:.2f}")
    print(native.BUILD_LOGS.get("beam_search", "").strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB > L2

    def flush():
        flush_buf.zero_()

    # 2. kernel against plain on the card
    kres = kernel_phase(bs, dev, flush)

    # 3. the main path through the entry points
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        outputs = os.path.join(tmp, "outputs")
        paths = write_images(img_dir, 16, rng)

        base = init_network(seed=0, device="cpu")            # ResNet101-SOLAR, full width
        flax_vars = perturb_flax(to_flax_variables(base.module.state_dict()), rng)
        ckpt = os.path.join(tmp, "resnet101-solar-smoke.pth")
        torch.save({"state_dict": from_flax_variables(flax_vars), "meta": base.meta}, ckpt)
        del base

        argv = ["--datasets", "gallery", "--outputs", outputs, "--data-root", img_dir,
                "--matching-method", "HNSW", "--network-path", ckpt, "--K", "10"]
        model = online.load_network(ckpt, device="cuda")
        t0 = time.perf_counter()
        real = extract_vectors(model, paths, image_size=1024, scales=DEFAULT_SCALES,
                               batch_size=4)
        torch.cuda.synchronize()
        print(f"gallery extract_s {time.perf_counter() - t0:.3f} for 16 images at 1024 px, "
              f"3 scales ({card})")
        check(real.shape == (16, 2048) and np.isfinite(real).all(), "bad descriptors")
        np.testing.assert_allclose(np.linalg.norm(real, axis=1), 1.0, atol=1e-4)
        del model

        centers = rng.standard_normal((64, 2048))
        synth = centers[rng.integers(0, 64, 4096)] + 0.6 * rng.standard_normal((4096, 2048))
        synth /= np.linalg.norm(synth, axis=1, keepdims=True)
        gallery = np.concatenate([real, synth]).astype(np.float32)
        rel = [os.path.basename(p) for p in paths] + [f"synthetic/{i:05d}" for i in range(4096)]
        save_path_feature("gallery", gallery, rel, root=outputs)
        t0 = time.perf_counter()
        ix = build_hnsw(gallery, m=16, ef_construction=100, device="cuda")
        print(f"hnsw build_s {time.perf_counter() - t0:.1f} for {gallery.shape[0]} x 2048 "
              "(host, native)", flush=True)
        save_index(ix, os.path.join(outputs, "gallery", "hnsw"))
        del ix

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

        # 4. the kernel at the served shapes: Q=1 (a POST) and Q=32 (the largest slot)
        qv = torch.as_tensor(gallery[:32], device=dev)
        qv = unit_rows(qv + 0.02 * torch.randn(qv.shape, device=dev,
                                               generator=torch.Generator(device=dev).manual_seed(1)))
        idx = svc.index
        top = torch.topk(qv @ idx.vectors[idx.coarse_ids.long()].T, 1, dim=1).indices[:, 0]
        starts = idx.coarse_ids[top].contiguous()
        served = []
        for q in (1, 32):
            rec = measure(bs, idx.vectors, idx.nbr0, qv[:q].contiguous(),
                          starts[:q].contiguous(), flush)
            served.append(rec)
            print("beam_search served:", json.dumps(rec), flush=True)
        svc.close()

    err = max([kres["n203"], kres["1m_float32"]["max_abs_err"],
               kres["1m_bfloat16"]["max_abs_err"]] + [r["max_abs_err"] for r in served])
    main_rec = served[0]
    print(json.dumps({"kernels": [{
        "name": "beam_search",
        "route": "cuda",
        "source": "image_search_engine_for_historical_research_tpu_torch/csrc/beam_search.cu",
        "replaces": "image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:354",
        "launches": launches,
        "max_abs_err": err,
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
