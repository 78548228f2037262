"""The PyTorch port stands alone: it imports no JAX, Flax or JAX-package code,
and its entry points refuse to run silently on the CPU when no GPU is present."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "image_search_engine_for_historical_research_tpu_torch"
JAX_PKG = "image_search_engine_for_historical_research_tpu"

_CPU_PATH = f"""
import sys
import numpy as np, torch
from {PKG}.cli import benchmark, offline, online
from {PKG}.index import build_flat, build_hnsw, build_hnsw_device, build_hnsw_pq, build_ivfpq, build_pq
from {PKG}.models import init_network, multiscale_descriptor
from {PKG}.serving import SearchService

model = init_network({{"architecture": "resnet50"}}, device="cpu")
with torch.inference_mode():
    v = multiscale_descriptor(model.module, torch.zeros(1, 64, 64, 3) + 0.5,
                              scales=(1.0, 0.5 ** 0.5))
ix = build_hnsw(np.random.default_rng(0).standard_normal((50, 2048)), m=4,
                ef_construction=16, device="cpu")
_, ids = ix.search(v, 3)
assert ids.shape == (1, 3)
flat = build_flat(np.random.default_rng(1).standard_normal((50, 2048)), device="cpu")
_, ids = flat.search(v, 3)
assert ids.shape == (1, 3)
rows = np.random.default_rng(2).standard_normal((60, 2048)).astype(np.float32)
for pq_ix in (build_pq(rows, M=16, Ks=16, iters=2, refine_M=8, device="cpu"),
              build_hnsw_pq(rows, M=16, Ks=16, iters=2, refine_M=8, opq="refine", opq_iters=1,
                            device="cpu"),
              build_ivfpq(rows, nlist=4, M=16, Ks=16, nprobe=2, iters=2, device="cpu")):
    _, ids = pq_ix.search(v, 3)
    assert ids.shape == (1, 3)
from {PKG}.ops import sift_extract_batch
from {PKG}.rerank import LocalFeatures
from {PKG}.rerank.geometric import adalam_count_pairs as count
img = np.random.default_rng(3).uniform(0, 1, (1, 64, 80)).astype(np.float32)
f = sift_extract_batch(img, max_kpts=32, n_octaves=2, device="cpu")[0]
lf = LocalFeatures(f["xy"], 2 * f["scale"], f["angle"], f["desc"], f["count"], (64, 80))
assert count([lf], [lf], device="cpu").shape == (1,)
from {PKG}.models import d2net, loftr
from {PKG}.rerank import loftr_rerank
from {PKG}.train import init_loftr_train_state, make_loftr_optimizer, make_loftr_train_step
m = loftr.init_matcher(device="cpu", initial_dim=16, block_dims=(16, 24, 32), d_coarse=32,
                       d_fine=16, nhead=4, coarse_layers=("self", "cross"))
pair = np.random.default_rng(4).uniform(0, 1, (1, 32, 48, 1)).astype(np.float32)
assert loftr.make_batched_count_fn(m)(pair, pair).shape == (1,)
state = init_loftr_train_state(m, *make_loftr_optimizer(m))
make_loftr_train_step()(state, torch.from_numpy(pair), torch.eye(3)[None])
k, s, d = d2net.process_multiscale(np.ones((32, 32, 3), np.float32), d2net.init_d2net(device="cpu"))
assert d.shape[1] == 512
import torch.distributed as dist
from {PKG}.parallel import data_mesh, sharded_exact_topk
mesh = data_mesh(device="cpu")
_, ids = sharded_exact_topk(torch.from_numpy(rows[:2]), torch.from_numpy(rows), 3, mesh)
assert ids[:, 0].tolist() == [0, 1]
build_pq(rows, M=16, Ks=16, iters=2, device="cpu", mesh=mesh)
from {PKG}.models import make_sharded_extract_fn
from {PKG}.train import init_train_state, make_optimizer, make_train_step
v = make_sharded_extract_fn(model.module, mesh, scales=(1.0,))(torch.zeros(2, 64, 64, 3) + 0.5)
assert v.shape == (2, 2048)
net = model.module.requires_grad_(True)
state = init_train_state(net, *make_optimizer(net)[:2])
_, loss = make_train_step(net, 3, lambda_sos=0.1, mesh=mesh)(
    state, torch.rand(3, 32, 32, 3), torch.tensor([-1, 1, 0], dtype=torch.int32))
assert torch.isfinite(loss) and state.step == 1
dist.destroy_process_group()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax") or m.split(".")[0] == "{JAX_PKG}"]
assert not bad, bad
print("OK")
"""


def test_port_cpu_path_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by tests/conftest.py)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CPU_PATH], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(REPO, PKG)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    sources = list(_port_sources())
    assert len(sources) > 20 and os.path.exists(sources[-1])
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax"), (path, mod)
            assert top != JAX_PKG, (path, mod)


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch, tmp_path):
    from image_search_engine_for_historical_research_tpu_torch.cli import (
        benchmark,
        common,
        offline,
        online,
    )
    from image_search_engine_for_historical_research_tpu_torch.index import (
        build_flat,
        build_hnsw,
        build_hnsw_device,
        build_hnsw_pq,
        build_ivfpq,
        build_pq,
        load_index,
    )
    from image_search_engine_for_historical_research_tpu_torch.models import init_network
    from image_search_engine_for_historical_research_tpu_torch.serving import SearchService

    from image_search_engine_for_historical_research_tpu_torch.ops import sift_extract_batch
    from image_search_engine_for_historical_research_tpu_torch.rerank import (
        AdalamFilter,
        make_adalam_verifier,
        make_verifier,
        sift_rerank,
    )
    from image_search_engine_for_historical_research_tpu_torch.rerank.geometric import (
        adalam_count_pairs,
    )

    from image_search_engine_for_historical_research_tpu_torch.models import d2net, loftr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tmp_path / "ckpt.pth"
    torch.save({}, ckpt)
    for entry in (loftr.init_matcher, lambda: loftr.load_loftr_checkpoint(str(ckpt)),
                  d2net.init_d2net, d2net.init_dense_net,
                  lambda: d2net.load_d2net_checkpoint(str(ckpt))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    for entry in (lambda: sift_extract_batch(np.zeros((1, 32, 32), np.float32)), AdalamFilter,
                  make_verifier, make_adalam_verifier,
                  lambda: adalam_count_pairs([None], [None]),
                  lambda: sift_rerank(["q"], ["d"], np.zeros((1, 1), np.int64),
                                      backend="device")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_network()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.load_network()
    from image_search_engine_for_historical_research_tpu_torch.parallel import data_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh()
    for build in (build_hnsw, build_hnsw_device, build_flat, build_pq, build_hnsw_pq,
                  build_ivfpq):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(np.ones((4, 8), np.float32))
    for cli in (offline.main, benchmark.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli(["--datasets", "db", "--data-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService(None, None, np.zeros((1, 8)), ["a"])
    for method in ("HNSW", "HNSW_NanoPQ", "IVFPQ", "PQ"):
        args = online.build_parser().parse_args(["--datasets", "db", "--matching-method", method])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            online.make_service(args)
