"""Run a function once on each rank of a local process group.

The port's process-group rule: NCCL when each rank has a GPU of its own,
gloo otherwise, which takes CPU tensors, and CUDA tensors staged through
the host when the ranks share one card (NCCL refuses two ranks on one
device).  The ranks meet at a ``FileStore`` in a temporary directory: no
address, no network.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve


def backend_for(device_type: str, world_size: int) -> str:
    """``"nccl"`` when ``world_size`` ranks on ``device_type`` tensors can
    each have a GPU of their own, else ``"gloo"``."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int, world_size: int) -> torch.device:
    """The device of ``rank``: its own GPU under NCCL, the first GPU shared
    under gloo, or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    if backend_for(device_type, world_size) == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


def run_ranks(fn, world_size: int, args: tuple = (), device=None) -> list:
    """``[fn(device, *args) on rank r for r in range(world_size)]``, each
    rank a process started with the ``spawn`` method inside an initialised
    default process group (``backend_for``), on ``rank_device`` of
    ``device``'s type (default: the card).  ``fn`` must be importable (a
    module-level function); its results come back through ``torch.save``
    in a temporary directory.  A rank that raises makes
    this raise after every rank has ended.  CPU ranks run one PyTorch
    thread each."""
    device_type = resolve(device).type
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world_size, device_type, tmp, args),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]


def _rank_main(rank, fn, world_size, device_type, tmp, args):
    device = rank_device(device_type, rank, world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend_for(device_type, world_size),
                            store=store, rank=rank, world_size=world_size)
    try:
        out = fn(device, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
