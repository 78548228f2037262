"""Build and load the port's native libraries (C++ and CUDA) through ctypes.

Port of ``image_search_engine_for_historical_research_tpu/native/__init__.py``,
extended to the CUDA kernels. Every library is compiled on first use from the
sources in this package into ``<package>/_build`` (listed in ``.gitignore``)
and rebuilt when a source is newer than it. A failed build raises; nothing is
installed or downloaded.

- ``hnsw``: the HNSW graph construction, ``native/hnsw_build.cpp``, with ``g++``.
- ``image_loader``: the threaded JPEG decoder, ``native/image_loader.cpp``,
  with ``g++``, linked against the system's libjpeg (``jpeglib.h`` and
  ``libjpeg.so``; a machine without them fails the build).
- ``beam_search``: the HNSW level-0 beam-search kernel,
  ``csrc/beam_search.cu``, with ``nvcc`` for ``sm_90a`` (Hopper), as a shared
  library with a plain C interface.
- ``beam_search_clocks``: the same source built with
  ``-DBEAM_SEARCH_PHASE_CLOCKS``, which adds per-phase ``clock64()`` sums
  (a measurement build; the served path never loads it).
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

# library -> (compiler, sources relative to the package, compile flags,
# link flags). Link flags go after the sources: a linker that drops libraries
# named before the objects that need them (``--as-needed``) would otherwise
# leave the library's symbols undefined.
_LIBRARIES = {
    "hnsw": ("g++", ["native/hnsw_build.cpp"], [], []),
    "image_loader": ("g++", ["native/image_loader.cpp"], [], ["-ljpeg"]),
    "beam_search": ("nvcc", ["csrc/beam_search.cu"], [], []),
    "beam_search_clocks": ("nvcc", ["csrc/beam_search.cu"], ["-DBEAM_SEARCH_PHASE_CLOCKS"], []),
}

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


def _commands(compiler: str, srcs: List[str], out: str, flags: List[str],
              link_flags: List[str] = ()) -> List[List[str]]:
    """Candidate build commands, tried in order (the first that works wins);
    ``link_flags`` come last, after the sources."""
    if compiler == "g++":
        base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *flags]
        tail = ["-o", out, *srcs, *link_flags]
        return [base + ["-march=native"] + tail, base + tail]
    return [[
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
        "-o", out, *srcs, *link_flags,
    ]]


def build(name: str) -> str:
    """Compile library ``name`` if it is missing or stale; return its path."""
    compiler, rel, flags, link_flags = _LIBRARIES[name]
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
    for cmd in _commands(compiler, srcs, tmp, flags, link_flags):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            with open(f"{tmp}.log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(f"{tmp}.log", f"{so_path}.log")
            os.replace(tmp, so_path)
            return so_path
        errors.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(f"building lib{name}.so failed:\n" + "\n".join(errors))


def build_log(name: str) -> str:
    """Compiler output of the build of library ``name`` (nvcc's -Xptxas -v
    report), kept beside the library."""
    with open(os.path.join(BUILD_DIR, f"lib{name}.so.log")) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load a native library by short name."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
