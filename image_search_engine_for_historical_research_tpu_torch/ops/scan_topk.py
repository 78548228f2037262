"""Exact inner-product top-k over an f32 gallery: the CUDA scan kernel with
the selection in its epilogue, and its plain PyTorch version.

The kernel is ``csrc/scan_topk.cu``, compiled with ``nvcc`` for ``sm_90a``
into a shared library and launched through ``ctypes``. It replaces no TPU
kernel: the JAX package leaves this scan to XLA's dot and ``lax.top_k``.
The port took it over from cuBLAS + ``torch.topk`` for the skinny shapes its
searches run, where cuBLAS's f32 kernel pads the query side to 64-row tiles
(Q = 70 costs what Q = 128 costs) and ``torch.topk`` reads the whole ``(Q,
N)`` score matrix back.

What bounds it: ``2 Q N D`` FMAs' worth of FLOPs on the f32 CUDA cores (no
tensor cores, no TF32) against one read of the gallery; at Q = 70 over
1,007,323 x 2048 rows the arithmetic (4.31 ms at 67 TFLOP/s) outweighs the
bytes (2.46 ms). The design (details at the top of the source): a
persistent grid walks gallery tiles of 512 rows with all Q <= 72 queries
(padded to a multiple of 8) in one block tile, D in 32-wide ``cp.async``
slices through a shared-memory ring, ``Q / 8`` x 16 f32 accumulators a
thread; each block appends the scores above its running
k-th key to a buffer per query in device memory and compacts it by a radix
select when it fills, and a second kernel merges the blocks' lists. The
``(Q, N)`` score matrix is never written.

Results are ``lax.top_k``'s: scores descending, and among equal scores the
lowest ids are selected and come first (``ops.topk._top_exact``'s rule, the
head of a stable descending sort).

``scan_topk`` runs the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``takes`` says whether the kernel
takes the arguments (``ops.topk`` routes by it); ``launches`` counts calls
that launched the kernel (each launches the scan and its merge).

Above 72 queries the kernel's accumulators no longer fit a thread, and
cuBLAS's 64-row query tiles fill up: a kernel tile for Q <= 128 took 14.0 ms
at Q = 128 against cuBLAS + ``torch.topk``'s 12.2 on an H100, so those
shapes stay with the library. ``MAX_Q`` and ``MAX_K`` are the limits the
library was compiled with (``scan_topk_max_q`` / ``_max_k``); they are
declared here so that a refusal never builds the library.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from ..utils import tracing

MAX_Q = 72         # the largest query tile: 8 warps x 9 queries
MAX_K = 128        # a block's list: 4 keys a lane

launches = 0       # calls that launched the kernel since import (or last reset)
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sizes: Dict[str, int] = {}   # the library's grid and buffer sizes, read once
_sm_counts = {}


def refusal(q: torch.Tensor, x: torch.Tensor, k: int) -> Optional[str]:
    """Why the kernel does not take ``q (Q, D)``, ``x (N, D)`` and ``k``, or
    ``None`` where it does."""
    if x.device.type != "cuda" or q.device != x.device:
        return f"q on {q.device} and x on {x.device}: the kernel runs on one CUDA device"
    return _operand_refusal(q, x, k)


def _operand_refusal(q: torch.Tensor, x: torch.Tensor, k: int) -> Optional[str]:
    """``refusal`` past the device: dtypes, shapes, layout and limits."""
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        return f"q is {q.dtype} and x {x.dtype}: the kernel takes float32 only"
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        return f"shapes {tuple(q.shape)} and {tuple(x.shape)}: want (Q, D) and (N, D)"
    if not (q.is_contiguous() and x.is_contiguous()):
        return "q and x must be contiguous"
    (Q, D), N = q.shape, x.shape[0]
    if not 1 <= Q <= MAX_Q:
        return f"Q = {Q}: the kernel takes 1 <= Q <= {MAX_Q}"
    if not 1 <= k <= min(MAX_K, N):
        return f"k = {k}: the kernel takes 1 <= k <= min({MAX_K}, N = {N})"
    if D == 0 or D % 4 or N >= 2 ** 31:
        return f"D = {D}, N = {N}: the kernel needs D % 4 == 0, D > 0 and N < 2**31"
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        return "q and x must start on a 16-byte boundary"
    return None


def takes(q: torch.Tensor, x: torch.Tensor, k: int) -> bool:
    """Whether the kernel takes ``(q, x, k)`` (``refusal`` is ``None``)."""
    return refusal(q, x, k) is None


def scan_topk(q: torch.Tensor, x: torch.Tensor, k: int):
    """Top-``k`` inner products of ``q (Q, D)`` against ``x (N, D)``:
    ``(scores (Q, k) f32 descending, ids (Q, k) int64)``, the lower id first
    among equal scores."""
    if q.device.type == "cpu" and x.device.type == "cpu":
        return scan_topk_reference(q, x, k)
    return _scan_topk_cuda(q, x, k)


def scan_topk_reference(q: torch.Tensor, x: torch.Tensor, k: int):
    """Plain version: the f32 inner products, then the head of a stable
    descending sort."""
    s = q.float() @ x.float().T
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..native import load

        lib = load("scan_topk")
        lib.scan_topk_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p] * 5)
        lib.scan_topk_launch.restype = ctypes.c_int
        lib.scan_topk_error_string.argtypes = [ctypes.c_int]
        lib.scan_topk_error_string.restype = ctypes.c_char_p
        for name in ("max_q", "max_k", "max_blocks", "tile_rows", "buffer_keys"):
            fn = getattr(lib, f"scan_topk_{name}")
            fn.argtypes, fn.restype = [], ctypes.c_int
            _sizes[name] = fn()
        _lib = lib
    return _lib


def _blocks(dev: torch.device, N: int) -> int:
    """The scan's persistent grid: one block an SM, at most one a tile of
    the library's ``tile_rows`` gallery rows and at most its ``max_blocks``
    (the lists its merge holds)."""
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(-(-N // _sizes["tile_rows"]), _sm_counts[dev.index], _sizes["max_blocks"])


def _scan_topk_cuda(q: torch.Tensor, x: torch.Tensor, k: int):
    global launches
    why = refusal(q, x, k)
    if why is not None:
        raise ValueError(f"scan_topk: {why}")
    (Q, D), N = q.shape, x.shape[0]
    dev = x.device
    lib = _library()
    blocks = _blocks(dev, N)
    cand = torch.empty((blocks, Q, _sizes["buffer_keys"]), dtype=torch.int64, device=dev)
    lists = torch.empty((blocks, Q, k), dtype=torch.int64, device=dev)
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int64, device=dev)
    with tracing.span("ops.scan_topk", q=Q, k=k), torch.cuda.device(dev):
        rc = lib.scan_topk_launch(x.data_ptr(), q.data_ptr(), N, D, Q, k, blocks,
                                  cand.data_ptr(), lists.data_ptr(), scores.data_ptr(),
                                  ids.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.scan_topk_error_string(rc).decode()
        raise RuntimeError(f"scan_topk kernel launch failed: CUDA error {rc} ({msg})")
    with _count_lock:
        launches += 1
    return scores, ids
