"""Device selection for measured runs: a CUDA card or an error."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees none.

    Measurement paths call this instead of falling back to the CPU: a CPU
    run says nothing about the card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", 0)
