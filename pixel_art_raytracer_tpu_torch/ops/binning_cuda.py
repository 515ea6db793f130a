"""Wrapper of the binning kernel (``csrc/binning.cu``): the full rebin's
per-bin tables of every frame, with no sort and no host wait.

``binning.bin_tables`` routes CUDA tensors here and takes the plain
version, :func:`binning.plain_tables`, for CPU tensors; this wrapper only
launches, and raises for a tensor on any other device.  The count pass
tiles the grid by TILE_BINS bins, so no grid is too large for it.
``launches`` counts kernel launches (two a call: count, then place).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels

launches = 0

# csrc/binning.cu kChunk: entities a count block takes.
CHUNK = 1024
# csrc/binning.cu kTileBins: bins a count block takes, each an int32 count
# and a 32-bit group mask in shared memory (64 KB).
TILE_BINS = 8192


def chunks(n: int) -> int:
    """Chunks of CHUNK entities the count pass splits ``n`` into, at least
    one."""
    return max(1, -(-n // CHUNK))


def tiles(config: RenderConfig) -> int:
    """Tiles of at most TILE_BINS bins the count pass splits the grid
    into."""
    return -(-config.hash_volume // TILE_BINS)


def smem_bytes(config: RenderConfig) -> int:
    """Shared memory of a count block: a count and a group mask a bin of
    its tile."""
    return 8 * min(config.hash_volume, TILE_BINS)


def scratch_shape(config: RenderConfig, n: int, frames: int) -> tuple:
    """The count pass's per-chunk counts and group masks: (2, frames,
    chunks, V) int32."""
    return (2, frames, chunks(n), config.hash_volume)


def check_window(window: int, ring: bool) -> None:
    """Raise ``ValueError`` for a window the layout cannot take: under 1,
    or not a power of two in the wrapped (``ring``) layout."""
    if window < 1:
        raise ValueError(f"bin_tables: window {window} < 1")
    if ring and window & (window - 1):
        raise ValueError(f"bin_tables: the wrapped layout needs a power of "
                         f"two, not window {window}")


def bin_tables(pos, ext, players, config: RenderConfig,
               spans: tuple[int, int, int], window: int, ring: bool,
               id_offset: int = 0):
    """``(ids (F, V, window), counts (F, V))`` int32 of ``binning.
    plain_tables``, computed by the kernel.

    pos, ext: (N, 3) int32; players: (F, 3) int32, entity 0's position
    in each frame, or None for one frame as ``pos`` has it.  ``ring``
    gives ``build_bins``' wrapped layout (``window`` a power of two),
    otherwise the static cache's left-aligned one (``plain_tables``).
    """
    global launches
    dev = pos.device
    N = pos.shape[0]
    F = 1 if players is None else players.shape[0]
    cfg = config
    V = cfg.hash_volume
    for t, name, shape in ((pos, "pos", (N, 3)), (ext, "ext", (N, 3)),
                           (players, "players", (F, 3))):
        if t is not None:
            kernels.require(t, name, torch.int32, shape, dev)
    check_window(window, ring)
    if dev.type != "cuda":
        raise ValueError(f"bin_tables: no kernel for device {dev}")

    scratch = torch.empty(scratch_shape(cfg, N, F), dtype=torch.int32,
                          device=dev)
    ids = torch.empty((F, V, window), dtype=torch.int32, device=dev)
    counts = torch.empty((F, V), dtype=torch.int32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_bin_tables(
            pos.data_ptr(), ext.data_ptr(),
            None if players is None else players.data_ptr(),
            scratch.data_ptr(), ids.data_ptr(), counts.data_ptr(), N, F,
            cfg.view_width, cfg.view_height, cfg.view_length, cfg.bin_size,
            cfg.hash_width, cfg.hash_height, cfg.hash_length, *spans,
            window, int(ring), id_offset,
            kernels.stream_handle(dev))
    kernels.check(rc, "par_bin_tables")
    launches += 2
    return ids, counts

