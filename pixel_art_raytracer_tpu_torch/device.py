"""Device selection: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import subprocess

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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for the
    first card; raises without a CUDA device.  Every time that a
    measurement prints stands beside this line: a card may be set below
    its full power limit, and then runs slower under load."""
    require_cuda()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]
