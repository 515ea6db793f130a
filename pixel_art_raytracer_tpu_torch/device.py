"""Device selection: the CUDA card unless the caller asks for the CPU."""

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


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card
    (:func:`require_cuda`).  Entry points take ``device=None`` so they run
    on the card unless the caller names another device."""
    return require_cuda() if device is None else torch.device(device)
