import pytest


@pytest.fixture
def cuda():
    """The card, or a skip (decided here, never while modules import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch.cuda.is_available() is False")
    return "cuda"
