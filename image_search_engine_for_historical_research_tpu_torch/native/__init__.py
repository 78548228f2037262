"""Build and load the port's native libraries (C++ and CUDA) through ctypes.

Port of ``image_search_engine_for_historical_research_tpu/native/__init__.py``,
extended to the CUDA kernels. Every library is compiled on first use from the
sources in this package into ``<package>/_build`` (listed in ``.gitignore``)
and rebuilt when a source is newer than it. A failed build raises; nothing is
installed or downloaded.

- ``hnsw``: the HNSW graph construction, ``native/hnsw_build.cpp``, with ``g++``.
- ``beam_search``: the HNSW level-0 beam-search kernel,
  ``csrc/beam_search.cu``, with ``nvcc`` for ``sm_90a`` (Hopper), as a shared
  library with a plain C interface.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

# library -> (compiler, sources relative to the package)
_LIBRARIES = {
    "hnsw": ("g++", ["native/hnsw_build.cpp"]),
    "beam_search": ("nvcc", ["csrc/beam_search.cu"]),
}

# compiler output of the last build of each library (nvcc's -Xptxas -v report)
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _commands(compiler: str, srcs: List[str], out: str) -> List[List[str]]:
    """Candidate build commands, tried in order (the first that works wins)."""
    if compiler == "g++":
        base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out, *srcs]
        return [base + ["-march=native"], base]
    return [[
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, *srcs,
    ]]


def build(name: str) -> str:
    """Compile library ``name`` if it is missing or stale; return its path."""
    compiler, rel = _LIBRARIES[name]
    srcs = [os.path.join(_PKG, s) for s in rel]
    so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= newest_src:
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    errors = []
    for cmd in _commands(compiler, srcs, tmp):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            os.replace(tmp, so_path)
            return so_path
        errors.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(f"building lib{name}.so failed:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load a native library by short name."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
