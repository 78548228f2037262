"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Without a GPU they raise instead of
carrying on silently on the CPU; the CPU path is taken only when the caller
asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
