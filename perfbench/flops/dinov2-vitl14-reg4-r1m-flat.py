"""Operation counts of ``dinov2-vitl14-reg4-r1m-flat``, from shapes alone
(the benchmark's yardstick: nothing here reads the port).

An upload is counted over its valid tokens alone, whatever the program
pads: at each scale the tokens are CLS, the registers and the patches
whose top-left pixel lies in the upload's mask (resized as the canvas is:
``nearest-exact``, sizes ``int(side * s)``). A FLOP is a multiply or an
add: a matrix product counts ``2 m n k``. Counted: the patch embedding
(``2 * 3 p^2 * D`` a kept patch), each block's ``qkv``, ``proj``, ``fc1``
and ``fc2``, and attention's two ``(N, N)`` products, ``4 N^2 D`` a block.
Not counted: LayerNorms, GELU, the softmax, LayerScale, residual adds,
the position grid's resize and the norms (elementwise work, under 1%).
"""

from __future__ import annotations


def _kept(size_out: int, size_in: int, extent: int, patch: int) -> int:
    """Patches along one side of a canvas of ``size_in`` resized to
    ``size_out`` whose first pixel maps (``nearest-exact``) inside the
    upload's ``extent``."""
    grid = size_out // patch
    scale = size_in / size_out
    return sum(min(int((r * patch + 0.5) * scale), size_in - 1) < extent for r in range(grid))


def valid_tokens(h: int, w: int, side: int, scale: float, cfg: dict) -> int:
    """Tokens of an ``h x w`` upload on a ``side`` canvas at ``scale``."""
    p, size = int(cfg["patch_size"]), int(side * scale)
    rows, cols = _kept(size, side, h, p), _kept(size, side, w, p)
    return 1 + int(cfg["num_register_tokens"]) + rows * cols


def block_linear_flops(n: int, cfg: dict) -> int:
    d, m = int(cfg["embed_dim"]), int(cfg["mlp_dim"])
    return 2 * n * d * (3 * d + d + 2 * m)


def block_attention_flops(n: int, cfg: dict) -> int:
    return 4 * n * n * int(cfg["embed_dim"])


def scale_flops(n: int, cfg: dict) -> int:
    """One scale over ``n`` tokens: the patch embedding and every block."""
    p, d, depth = int(cfg["patch_size"]), int(cfg["embed_dim"]), int(cfg["depth"])
    patches = n - 1 - int(cfg["num_register_tokens"])
    return 2 * 3 * p * p * d * patches + depth * (block_linear_flops(n, cfg)
                                                 + block_attention_flops(n, cfg))


def upload_flops(h: int, w: int, cfg: dict) -> int:
    """FLOPs of one upload over its valid tokens at every scale."""
    side = -(-int(cfg["image_size"]) // 32) * 32
    return sum(scale_flops(valid_tokens(h, w, side, s, cfg), cfg) for s in cfg["scales"])


def upload_attention_flops(h: int, w: int, cfg: dict) -> int:
    """The attention core's share of ``upload_flops``: ``softmax(q kᵀ) v``'s
    two products in every block at every scale."""
    side = -(-int(cfg["image_size"]) // 32) * 32
    return sum(int(cfg["depth"]) * block_attention_flops(valid_tokens(h, w, side, s, cfg), cfg)
               for s in cfg["scales"])
