"""One rank of the gloo world that ``tests/test_torch_port_parallel_steps.py``
spawns: every batch-sharded step of the port (extraction, ``extract_vectors``
with padded batches, SIFT, the SOLAR and LoFTR train steps, ``cli.extract_1m
--mesh`` in both modes) on the inputs the test wrote. Each rank writes its
results to its own npz: keys that start with ``rank_`` hold what differs by
rank (who wrote which file; rank 0 alone writes the gradients, under
``g0_``), every other key must be the same on every rank. Imports no JAX.

    python tests/torch_port_parallel_steps_worker.py RANK WORLD DIR
"""

import contextlib
import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from image_search_engine_for_historical_research_tpu_torch import parallel
from image_search_engine_for_historical_research_tpu_torch.cli import extract_1m
from image_search_engine_for_historical_research_tpu_torch.cli.common import load_network
from image_search_engine_for_historical_research_tpu_torch.models import (
    extract_vectors,
    make_sharded_extract_fn,
)
from image_search_engine_for_historical_research_tpu_torch.models import loftr as tloftr
from image_search_engine_for_historical_research_tpu_torch.ops import make_sharded_sift_fn
from image_search_engine_for_historical_research_tpu_torch.train import (
    init_loftr_train_state,
    init_train_state,
    make_grad_fn,
    make_loftr_optimizer,
    make_loftr_train_step,
    make_optimizer,
    make_train_step,
)

# name: (S, tuples, loss, margin, lambda_sos); with S=4 and 3 tuples, 6
# images a rank, tuple 1 lies across the two ranks' blocks
SOLAR_CASES = {
    "sos": (3, 8, "contrastive", 0.7, 0.1),
    "straddle": (4, 3, "contrastive", 0.7, 0.1),
    "triplet": (4, 3, "triplet", 0.1, 0.0),
}
LOFTR_SMALL = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4,
                   coarse_layers=("self", "cross"), thr=0.0, max_matches=24)
LOFTR_CASES = {"plain": None, "accum2": 2}
SIFT_KW = dict(max_kpts=128, n_octaves=3)
PAD_BATCH = 4
CLI_ARGS = ["--image-size", "64", "--multiscale", "[1]", "--batch-size", "2",
            "--checkpoint-every", "4", "--device", "cpu"]


def solar_labels(S, tuples):
    return np.tile(np.array([-1, 1] + [0] * (S - 2), np.int32), tuples)


def cli_argv(directory, out, *extra):
    return (["--data-root", str(directory), "--outputs", str(out), "--network-path",
             os.path.join(str(directory), "solar_ckpt.pth")] + CLI_ARGS + list(extra))


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return np.array(h.hexdigest())


@contextlib.contextmanager
def counting(module, name, calls):
    """``module.name`` wrapped so that each call appends ``(its first
    argument, its return value)`` to ``calls``."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        res = fn(*a, **kw)
        calls.append((a[0] if a else None, res))
        return res

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def solar_net(directory, timeout=300.0):
    """The SOLAR model of the checkpoint the test writes (atomically) while
    the ranks run SIFT and LoFTR."""
    path = os.path.join(directory, "solar_ckpt.pth")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)
    return load_network(path, device="cpu")


def run_extraction(inp, mesh, directory, out):
    t = torch.from_numpy
    net = solar_net(directory)
    fn = make_sharded_extract_fn(net.module, mesh, scales=(1.0,))
    images, mask = t(inp["extract_images"]), t(inp["extract_mask"])
    v = fn(images, mask)
    out["extract_v"] = v
    out["extract_from_shard_batch_equal"] = np.array(torch.equal(
        fn(parallel.shard_batch(images, mesh), parallel.shard_batch(mask, mesh)), v))
    try:
        fn(images[:3], mask[:3])
        out["extract_indivisible_raised"] = np.array(False)
    except ValueError as e:
        out["extract_indivisible_raised"] = np.array("divisible" in str(e))

    shapes = []

    def seen(images, mask):
        shapes.append(tuple(images.shape))
        return fn(images, mask)

    paths = sorted(os.path.join(directory, "pad", n) for n in os.listdir(
        os.path.join(directory, "pad")))
    out["pad_rows"] = extract_vectors(net, paths, 48, batch_size=PAD_BATCH, extract_fn=seen,
                                      pad_batches=True)
    out["pad_batch_sizes"] = np.array([s[0] for s in shapes])


def run_sift(inp, mesh, out):
    imgs = torch.from_numpy(inp["sift_images"])
    res = make_sharded_sift_fn(mesh, tuple(imgs.shape[1:]), **SIFT_KW)(imgs)
    out.update({f"sift_{k}": v for k, v in res.items()})
    try:
        make_sharded_sift_fn(mesh, (64, 64), **SIFT_KW)(imgs)
        out["sift_hw_raised"] = np.array(False)
    except ValueError:
        out["sift_hw_raised"] = np.array(True)


def run_solar(inp, mesh, directory, out, rank):
    net = solar_net(directory)
    module = net.module.requires_grad_(True)
    for case, (S, tuples, loss, margin, lam) in SOLAR_CASES.items():
        images = torch.from_numpy(inp[f"solar_{case}_images"])
        mask = torch.ones(images.shape[:3], dtype=torch.bool)
        labels = torch.from_numpy(solar_labels(S, tuples))
        module.zero_grad(set_to_none=True)
        value = make_grad_fn(module, S, loss, margin, lam, mesh=mesh)(images, labels, mask)
        out[f"solar_{case}_loss"] = value
        named = [(n, p.grad) for n, p in module.named_parameters()]
        out[f"solar_{case}_grad_digest"] = digest(g for _, g in named)
        if rank == 0:
            out.update({f"rank_g0_{case}/{n}": g for n, g in named})
    module.zero_grad(set_to_none=True)

    # two sharded steps with update_every=2: one optimizer update of the
    # gradients' running mean; the parameters must be the same on every rank
    S, tuples, loss, margin, lam = SOLAR_CASES["straddle"]
    opt, sched, _ = make_optimizer(module, lr=1e-3, weight_decay=1e-4)
    state = init_train_state(module, opt, sched, update_every=2)
    step = make_train_step(module.clone(frozen_stages=3), S, loss, margin, lam, mesh=mesh)
    images = parallel.shard_batch(torch.from_numpy(inp["solar_straddle_images"]), mesh)
    labels = torch.from_numpy(solar_labels(S, tuples))
    before = digest(module.parameters())
    losses = [step(state, images, labels)[1] for _ in range(2)]
    out["solar_step_losses"] = torch.stack(losses)
    out["solar_step_moved"] = np.array(digest(module.parameters()) != before)
    out["solar_step_param_digest"] = digest(module.parameters())


def run_loftr(inp, mesh, directory, out, rank):
    state_dict = torch.load(os.path.join(directory, "loftr.pt"))
    imgs, Hs = torch.from_numpy(inp["loftr_imgs"]), torch.from_numpy(inp["loftr_Hs"])
    for case, accum in LOFTR_CASES.items():
        m = tloftr.LoFTRMatcher(tloftr.LoFTRConfig(**LOFTR_SMALL))
        m.load_state_dict(state_dict)
        opt, sch = make_loftr_optimizer(m, lr=3e-4, warmup_steps=2)
        state = init_loftr_train_state(m, opt, sch)
        _, loss = make_loftr_train_step(accum=accum, mesh=mesh)(state, imgs, Hs)
        out[f"loftr_{case}_loss"] = loss
        out[f"loftr_{case}_param_digest"] = digest(m.parameters())
        if rank == 0:
            out.update({f"rank_g0_loftr_{case}/{n}": p.grad for n, p in m.named_parameters()})
    try:   # 6 pairs: 3 a rank, which accum=2 does not divide (6 % 2 == 0 would do in JAX)
        make_loftr_train_step(accum=2, mesh=mesh)(state, imgs[:6], Hs[:6])
        out["loftr_accum_error"] = np.array("")
    except ValueError as e:
        out["loftr_accum_error"] = np.array(str(e))


def run_cli(mesh, directory, out, rank):
    """``cli.extract_1m --mesh`` in both modes, each resumed: every rank
    counts the files it writes and removes and the resume points it reads."""
    d = str(directory)
    oneshot, shards = os.path.join(d, "cli_oneshot"), os.path.join(d, "cli_shards")
    if rank == 0:   # a checkpoint of 4 sentinel rows: every rank must resume after them
        os.makedirs(oneshot)
        np.savez(os.path.join(oneshot, "revisitop1m_partial.npz"),
                 vecs=np.full((7, 2048), 0.125, np.float32), done=4)
    dist.barrier()
    savez, removed, stores, shard_files, resumes = [], [], [], [], []
    with counting(np, "savez", savez), counting(os, "remove", removed), \
            counting(extract_1m, "save_path_feature", stores):
        assert extract_1m.main(cli_argv(d, oneshot, "--mesh")) == 0
    with counting(extract_1m, "save_feature_shard", shard_files), \
            counting(extract_1m, "shard_resume_point", resumes):
        assert extract_1m.main(cli_argv(d, shards, "--mesh", "--shard-size", "3",
                                        "--limit", "4")) == 0
        assert extract_1m.main(cli_argv(d, shards, "--mesh", "--shard-size", "3")) == 0
    checkpoints = [f for f, _ in savez if str(f).endswith("_partial.npz")]
    out["cli_resume_points"] = np.array([start for _, start in resumes])
    out["rank_cli_writes"] = np.array([len(checkpoints), len(stores), len(shard_files),
                                       len(removed)])
    out["cli_still_initialized"] = np.array(dist.is_initialized())


def main(rank, world, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'rendezvous')}",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = parallel.data_mesh(world, device="cpu")
        inp = dict(np.load(os.path.join(directory, "inputs.npz")))
        run_sift(inp, mesh, out)
        run_loftr(inp, mesh, directory, out, rank)
        run_extraction(inp, mesh, directory, out)
        run_solar(inp, mesh, directory, out, rank)
        run_cli(mesh, directory, out, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(directory, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in out.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
