"""One rank of the gloo world that ``tests/test_torch_port_parallel.py``
spawns: every sharded build of the port on the inputs the test wrote, each
rank's results written to its own npz. Imports no JAX: the JAX package's
draws (k-means initial centres, RP-forest level draws) come in the inputs
and are substituted at the port's seams.

    python tests/torch_port_parallel_worker.py RANK WORLD INIT_FILE INPUTS OUT
"""

import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from image_search_engine_for_historical_research_tpu_torch import parallel
from image_search_engine_for_historical_research_tpu_torch.index import (
    build_hnsw_device,
    build_ivfpq,
    build_pq,
    build_rpforest,
)
from image_search_engine_for_historical_research_tpu_torch.index import rpforest
from image_search_engine_for_historical_research_tpu_torch.index.graph_build import (
    build_knn_graph,
)
from image_search_engine_for_historical_research_tpu_torch.ops import kmeans
from image_search_engine_for_historical_research_tpu_torch.ops.kmeans import kmeans_fit_sharded
from image_search_engine_for_historical_research_tpu_torch.rerank import build_diffusion_offline

PQ_KW = dict(M=4, Ks=8, iters=8, normalize=False, device="cpu")
OPQ_KW = dict(PQ_KW, opq=True, opq_iters=3)
IVF_KW = dict(nlist=8, M=4, Ks=16, nprobe=4, train_fraction=0.5, device="cpu")
GRAPH_KW = dict(m=8, k_candidates=16, batch=128, normalize=False, device="cpu")
DIFF_KW = dict(n_trunc=64, kd=16, batch=64)
FOREST_KW = dict(n_trees=9, leaf_size=32, seed=3, normalize=False, device="cpu")


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def table_inits(inputs, prefix):
    """``ops.kmeans._init_centers_batched`` answering from the JAX initial
    centres ``inputs[prefix]`` for its ``(M, N, d, k)``, else as before."""
    table = torch.from_numpy(np.array(inputs[prefix]))
    original = kmeans._init_centers_batched

    def init(x, k, seeds, init):
        if (x.shape[0], k, x.shape[2]) == tuple(table.shape) and x.shape[1] == int(
                inputs[prefix + "_rows"]):
            return table.clone()
        return original(x, k, seeds, init)

    return patched(kmeans, "_init_centers_batched", init)


def table_forest_draws(inputs):
    """``index.rpforest._level_draws`` answering from JAX's draws."""
    def draws(seed, n_trees, tree, level, N, n_segs, D):
        return tuple(torch.from_numpy(inputs[f"forest_draw_{tree}_{level}_{i}"])
                     for i in range(3))

    return patched(rpforest, "_level_draws", draws)


def arrays(ix):
    return ix.to_arrays()[1]


def run_cases(inputs, mesh):
    out = {}
    t = torch.from_numpy

    s, i = parallel.sharded_exact_topk(t(inputs["topk_q"]), t(inputs["topk_db"]), 17, mesh)
    out.update(topk_s=s, topk_i=i)
    # k above a shard's rows, the gallery given as shard_batch's DTensor
    db = parallel.shard_batch(t(inputs["topk_db2"]), mesh)
    s, i = parallel.sharded_exact_topk(parallel.replicate(t(inputs["topk_q2"]), mesh), db,
                                       int(inputs["topk_k2"]), mesh)
    out.update(topk2_s=s, topk2_i=i)
    raised = []
    for call in (lambda: parallel.sharded_exact_topk(torch.zeros(1, 4), torch.zeros(11, 4), 2,
                                                     mesh),
                 lambda: parallel.shard_batch(torch.zeros(11, 4), mesh),
                 lambda: kmeans_fit_sharded(torch.zeros(11, 4), 2, mesh)):
        try:
            call()
            raised.append(False)
        except ValueError as e:
            raised.append("divisible" in str(e))
    out["indivisible_raised"] = np.array(raised)

    with table_inits(inputs, "kmeans_init"):
        c, a = kmeans_fit_sharded(t(inputs["kmeans_x"]), 8, mesh, iters=10)
    out.update(kmeans_c=c, kmeans_a=a)

    with table_inits(inputs, "pq_init"):
        ix = build_pq(inputs["pq_x"], mesh=mesh, **PQ_KW)
    out.update(pq_codewords=ix.codewords, pq_codes=ix.codes.long())

    ix = build_pq(inputs["pq_x"], mesh=mesh, **OPQ_KW)
    out.update(opq_codewords=ix.codewords, opq_rotation=ix.rotation,
               opq_codes=ix.codes.long())

    x = inputs["pq_x"]
    kw = dict(PQ_KW, train_sample=256, refine_M=4)
    with table_inits(inputs, "stream_init"):
        mem = arrays(build_pq(x, mesh=mesh, **kw))
        stream = arrays(build_pq(lambda: (x[s:s + 100] for s in range(0, len(x), 100)),
                                 n=len(x), mesh=mesh, **kw))
    out.update({f"stream_{k}": v for k, v in stream.items()})
    out["stream_equals_memory"] = np.array([mem.keys() == stream.keys() and all(
        np.array_equal(mem[k], stream[k]) for k in mem)])

    g = torch.from_numpy(inputs["graph_x"]).to(torch.bfloat16)
    ids, sc = build_knn_graph(g, 16, batch=128, mesh=mesh)
    out.update(knn_ids=ids, knn_sc=sc)
    ix = build_hnsw_device(inputs["graph_x"], mesh=mesh, **GRAPH_KW)
    out.update(hnsw_nbr0=ix.nbr0, hnsw_nbru=ix.nbru, hnsw_entry=np.array(ix.entry),
               hnsw_search=ix.search(t(inputs["graph_q"]), 10, ef=64)[1])

    off = build_diffusion_offline(t(inputs["diff_x"]), mesh=mesh, **DIFF_KW)
    out.update(diff_ids=off.trunc_ids, diff_scores=off.scores)

    ix = build_ivfpq(inputs["ivf_x"], mesh=mesh, **IVF_KW)
    out["ivf_ids"] = ix.search(t(inputs["ivf_x"][:16]), 5)[1]

    with table_forest_draws(inputs):
        ix = build_rpforest(inputs["forest_x"], mesh=mesh, **FOREST_KW)
    out.update(forest_leaf_items=ix.leaf_items, forest_thresholds=ix.thresholds,
               forest_planes=ix.planes.float())
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}


def main(rank, world, init_file, inputs_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = parallel.data_mesh(world, device="cpu")
        out = run_cases(dict(np.load(inputs_path)), mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
