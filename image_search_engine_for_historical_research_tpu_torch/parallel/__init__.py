"""Multi-GPU builds over ``torch.distributed``: mesh helpers and the
database-sharded top-k merge (port of the JAX package's ``parallel/``)."""

from .mesh import data_mesh, replicate, shard_batch
from .topk import sharded_exact_topk

__all__ = ["data_mesh", "replicate", "shard_batch", "sharded_exact_topk"]
