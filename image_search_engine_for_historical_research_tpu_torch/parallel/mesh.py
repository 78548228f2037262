"""Process groups and row sharding for multi-GPU builds.

Port of ``image_search_engine_for_historical_research_tpu/parallel/mesh.py``
(:17-44). The JAX package drives a ``Mesh`` from one controller and annotates
arrays with ``NamedSharding``; the port runs SPMD over ``torch.distributed``:
every rank (one process a GPU, started by ``torchrun --nproc-per-node N``)
calls the same build on the same full input and gets back the same full,
replicated result on its own device. ``NamedSharding(mesh, P(axis))`` becomes
a ``DTensor`` with ``[Shard(0)]`` (``shard_batch``) and ``P()`` one with
``[Replicate()]`` (``replicate``).

The sharded functions take their row-sharded input either as a plain full
tensor, of which each rank uses its own contiguous row block
(``local_rows``), or as the result of ``shard_batch``. Rows must divide the
mesh, as in the JAX package.

The batch-sharded steps (extraction, SIFT, the train steps) keep the same
contract: each rank runs its own rows, then ``gather_rows`` or
``all_reduce_flat`` hands every rank the whole result.

Collectives are NCCL on the card and gloo on the CPU (the tests). Nothing
falls back: without NCCL a card mesh raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..device import resolve_device


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (else ``rank % device_count``)
    on the card, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def data_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``axis`` over the default process group.

    With no group started, starts one (NCCL on ``cuda``, gloo on ``cpu``):
    under a launcher that sets ``WORLD_SIZE`` (``torchrun``) from its
    environment, else a world of 1 in this process from an in-memory store.
    Raises if ``n_devices`` is not the world size, if a ``cuda`` mesh would
    run on another backend than NCCL, and without a GPU unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this torch build lacks")
        torch.cuda.set_device(rank_device("cuda"))
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dev.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a cuda mesh needs an NCCL process group, not {dist.get_backend()!r}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data_mesh({n_devices}) in a world of {world} processes: start "
                         f"one process a device (torchrun --nproc-per-node {n_devices})")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def mesh_size(mesh, axis: str = "data") -> int:
    """The number of ranks along ``axis`` (``TypeError`` for a non-mesh)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.data_mesh), "
                        f"not {type(mesh).__name__}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _check_rows(n: int, mesh: DeviceMesh, axis: str) -> int:
    size = mesh_size(mesh, axis)
    if n % size:
        raise ValueError(f"rows {n} not divisible by mesh axis {axis!r} of {size}")
    return n // size


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """``x``'s rows split in contiguous blocks over ``axis`` (rank 0's
    values); raises ``ValueError`` when the rows do not divide the mesh."""
    _check_rows(x.shape[0], mesh, axis)
    x = torch.as_tensor(x).to(rank_device(mesh.device_type))
    return distribute_tensor(x, mesh, [Shard(0)])


def replicate(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """``x`` replicated on every rank of ``mesh`` (rank 0's values)."""
    x = torch.as_tensor(x).to(rank_device(mesh.device_type))
    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)


def local_rows(x, mesh: DeviceMesh, axis: str = "data"):
    """``(this rank's row block, the global row count)`` of ``x``: a
    ``shard_batch`` result's local shard, or a view of a full tensor's
    contiguous block. Raises ``ValueError`` on rows that do not divide."""
    rows = _check_rows(x.shape[0], mesh, axis)
    if isinstance(x, DTensor):
        if not isinstance(x.placements[0], Shard) or x.placements[0].dim != 0:
            return local_rows(x.full_tensor(), mesh, axis)
        return x.to_local(), x.shape[0]
    r = mesh.get_local_rank(axis)
    return x[r * rows:(r + 1) * rows], x.shape[0]


def full_rows(x) -> torch.Tensor:
    """``x`` as a plain full tensor (a ``DTensor`` is gathered)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data", dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (an
    all-gather), on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh_size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim)


def all_reduce_flat(tensors, mesh: DeviceMesh, axis: str = "data", mean: bool = False) -> None:
    """Sum each of ``tensors`` over ``axis`` in place (the mean with
    ``mean``), as one collective over one flat buffer rather than one a
    tensor. Every rank must pass the same shapes in the same order."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    if mean:
        flat /= mesh_size(mesh, axis)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
