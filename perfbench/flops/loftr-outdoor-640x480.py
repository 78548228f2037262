"""Operation counts of ``loftr-outdoor-640x480``'s count path, from
shapes alone (the benchmark's yardstick: nothing here reads the port).

The count path is what ``make_batched_count_fn`` runs: ResNet-FPN_8_2's
coarse path (the stem, layers 1-3, ``layer3_outconv``; the FPN's top-down
path only feeds the fine stage), the coarse transformer, and the (L, S)
similarity of the dual softmax. A FLOP is a multiply or an add.
Counted: convolutions, the attention's projections, its linear
attention products (``k^T v``, ``q (k^T v)`` and the normaliser
``q sum(k)``), the merge, the MLP and the similarity. Not counted:
BN, ReLU, ELU, LayerNorm, the softmaxes and the selection (elementwise).
"""

from __future__ import annotations


def _out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def backbone_flops(h: int, w: int, initial_dim: int, block_dims) -> tuple:
    """One grey image through the coarse path: (FLOPs, h/8, w/8)."""
    def conv(h, w, cin, cout, k, s=1):
        ho, wo = _out(h, k, s), _out(w, k, s)
        return 2 * cin * cout * k * k * ho * wo, ho, wo

    total, (h, w) = 0, (h, w)
    f, h, w = conv(h, w, 1, initial_dim, 7, 2)
    total += f
    cin = initial_dim
    for planes, stride in zip(block_dims, (1, 2, 2)):
        for b in range(2):
            s = stride if b == 0 else 1
            f1, ho, wo = conv(h, w, cin, planes, 3, s)
            f2, _, _ = conv(ho, wo, planes, planes, 3)
            total += f1 + f2
            if s != 1:
                total += conv(h, w, cin, planes, 1, s)[0]
            h, w, cin = ho, wo, planes
    total += 2 * cin * cin * h * w                                  # layer3_outconv
    return total, h, w


def layer_flops(length: int, source: int, d: int, nhead: int) -> int:
    """One encoder layer on one sequence of ``length`` attending ``source``."""
    proj = 2 * length * d * d + 2 * 2 * source * d * d              # q; k and v
    attn = 2 * source * d * d // nhead + 2 * length * d * d // nhead \
        + 2 * length * d                                            # k^T v, q kv, q sum(k)
    return proj + attn + 2 * length * d * d + 2 * length * (2 * d) * (2 * d) \
        + 2 * length * (2 * d) * d                                  # merge, mlp


def block_flops(pairs: int, h: int, w: int, m: dict) -> int:
    """FLOPs of one block of ``pairs`` pairs at ``h x w``."""
    bb, hc, wc = backbone_flops(h, w, m["initial_dim"], m["block_dims"])
    length, d = hc * wc, m["d_model"]
    per_layer = 2 * pairs * layer_flops(length, length, d, m["nhead"])
    sim = pairs * 2 * length * length * d
    return 2 * pairs * bb + len(m["layer_names"]) * per_layer + sim
