"""Operation and byte counts of ``solar-r101-r1m-flat``, from shapes
alone (the benchmark's yardstick: nothing here reads the port).

A FLOP is a multiply or an add: a convolution counts ``2 Cin Cout k^2``
per output position, a matrix product ``2 m n k``. Counted: every
convolution of ResNet101-SOLAR (torchvision v1.5 strides), SOA's 1x1
projections and its two (N, N) products, and the whitening. Not counted:
BN affines, ReLUs, masks, the softmax, GeM, resizes and norms (elementwise
work, under 1% of the total).
"""

from __future__ import annotations

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(h: int, w: int, cin: int, cout: int, k: int, s: int = 1) -> tuple:
    ho, wo = _out(h, k, s, k // 2), _out(w, k, s, k // 2)
    return 2 * cin * cout * k * k * ho * wo, ho, wo


def net_flops(h: int, w: int, architecture: str = "resnet101", soa_layers: str = "45",
              dim: int = 2048) -> int:
    """FLOPs of one image of ``h x w`` through the net (one scale)."""
    total, (h, w) = 0, (h, w)
    f, h, w = _conv(h, w, 3, 64, 7, 2)
    total += f
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)                    # max-pool
    cin = 64
    for i, (n, width, stride) in enumerate(zip(STAGES[architecture], (64, 128, 256, 512),
                                               (1, 2, 2, 2)), 1):
        for b in range(n):
            s = stride if b == 0 else 1
            total += 2 * cin * width * h * w                        # conv1 1x1
            f, ho, wo = _conv(h, w, width, width, 3, s)             # conv2 3x3
            total += f + 2 * width * width * 4 * ho * wo            # conv3 1x1
            if b == 0:
                total += 2 * cin * width * 4 * ho * wo              # downsample 1x1
            h, w, cin = ho, wo, width * 4
        if (i == 3 and "4" in soa_layers) or (i == 4 and "5" in soa_layers):
            total += soa_flops(h, w, cin)
    return total + 2 * dim * dim                                     # whitening


def soa_flops(h: int, w: int, c: int) -> int:
    """SOA over an (h, w, c) map: f, g, h at c/4 (stage 4) or c/2 (stage 5)
    channels, the (N, N) logits and the attention-weighted sum, and ``v``."""
    mid = c // 4 if c == 1024 else c // 2
    n = h * w
    return 3 * 2 * c * mid * n + 2 * 2 * n * n * mid + 2 * mid * c * n


def descriptor_flops(side: int, scales, architecture: str = "resnet101",
                     soa_layers: str = "45") -> int:
    """FLOPs of one ``side x side`` canvas over every scale (each scale
    resized to ``int(side * s)``, as the extraction does)."""
    return sum(net_flops(int(side * s), int(side * s), architecture, soa_layers)
               for s in scales)


def scan_flops_bytes(q: int, n: int, d: int, k: int, itemsize: int = 4) -> tuple:
    """One exact scan: ``2 Q N D`` FLOPs; bytes read once (gallery and
    queries) and the top-k written once (scores and ids, 8 bytes a slot)."""
    return 2 * q * n * d, n * d * itemsize + q * d * itemsize + q * k * 8
