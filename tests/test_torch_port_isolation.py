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
from {PKG}.cli import online
from {PKG}.index import build_hnsw
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
    from image_search_engine_for_historical_research_tpu_torch.cli import common, online
    from image_search_engine_for_historical_research_tpu_torch.index import (
        build_hnsw,
        load_index,
    )
    from image_search_engine_for_historical_research_tpu_torch.models import init_network
    from image_search_engine_for_historical_research_tpu_torch.serving import SearchService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_network()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.load_network()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_hnsw(np.ones((4, 8), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService(None, None, np.zeros((1, 8)), ["a"])
    args = online.build_parser().parse_args(["--datasets", "db", "--matching-method", "HNSW"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        online.make_service(args)
