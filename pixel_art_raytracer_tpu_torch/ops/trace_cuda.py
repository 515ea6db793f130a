"""Wrapper of kernel 1 (``csrc/trace.cu``): per-pixel winner entities.

CPU tensors take the plain version, :func:`ops.trace.trace_winner`; CUDA
tensors launch the kernel, and anything else raises.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels
from . import trace

launches = 0

# The default limit of shared memory a block; the kernel asks for no more.
MAX_SMEM = 48 * 1024
# csrc/common.cuh kBandPixels: the most pixels of a walk band.
BAND_PIXELS = 1600


def band_rows(config: RenderConfig) -> int:
    """Rows of a walk band (csrc/common.cuh ``Grid::band_rows``): the most
    rows of a bin-column tile whose pixels fit BAND_PIXELS, at least one
    (40 for 40-pixel bins: one band a tile; 20 for 80-pixel bins, 10 for
    160)."""
    bs = config.bin_size
    return max(1, min(bs, BAND_PIXELS // bs))


def bands(config: RenderConfig) -> int:
    """Bands a bin-column tile is walked in: one block each."""
    return -(-config.bin_size // band_rows(config))


def band_pixels(config: RenderConfig) -> int:
    """Pixels of the largest band."""
    return band_rows(config) * config.bin_size


def block_threads(config: RenderConfig) -> int:
    """Threads per block: one block walks a band's pixels, so take the
    largest warp multiple up to 512 (the kernel's launch bound) that
    divides them (320 for 1,600-pixel bands), else 256."""
    n_pix = band_pixels(config)
    return next((t for t in range(512, 31, -32) if n_pix % t == 0), 256)


def draw_bytes(config: RenderConfig) -> int:
    """Shared memory of the walk's draw list (csrc/common.cuh
    ``draw_ints``): 4 ints, then 16 a slot of the bin column."""
    return 4 * (4 + 16 * config.hash_length * config.bin_capacity)


def smem_bytes(config: RenderConfig) -> int:
    """Shared memory of one block: the bin column's draw list, its staged
    candidates (hash_l * (1 + 8 * cap) ints), and the best key, slot and
    adjacent-hit state of each pixel of a band."""
    cfg = config
    return draw_bytes(cfg) + 4 * (cfg.hash_length * (1 + 8 * cfg.bin_capacity)
                                  + 3 * band_pixels(cfg))


def trace_winners(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                  players, config: RenderConfig, with_best: bool = False,
                  rows=None):
    """Winner entity per pixel, (F, H, W) int32, -1 for background.

    Arguments as :func:`ops.trace.trace_winner`; ``rows=(row0, n_rows)``
    launches over that window of whole bin rows only
    (``trace.row_window``), for (F, n_rows, W) winners.  With ``with_best``
    the result is ``(best_depth, winner)`` as that function returns it.
    """
    global launches
    dev = bins_ent.device
    row0, n_rows = trace.row_window(config, rows)
    if dev.type == "cpu":
        best, winner = trace.trace_winner(pos, ext, sprite_id, atlas_depth,
                                          bins_ent, counts, players, config,
                                          rows=rows)
        return (best, winner) if with_best else winner
    if dev.type != "cuda":
        raise ValueError(f"trace_winners: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    S, sh, sw = atlas_depth.shape
    for t, name, dtype, shape in (
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (sprite_id, "sprite_id", torch.int32, (N,)),
            (atlas_depth, "atlas_depth", torch.int32,
             (S, cfg.sprite_height, cfg.sprite_width)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (players, "players", torch.int32, (F, 3))):
        kernels.require(t, name, dtype, shape, dev)
    smem = smem_bytes(cfg)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_winners: a bin column of {cfg.hash_length}"
                         f" x {cap} slots and a band of "
                         f"{band_pixels(cfg)} pixels need {smem} B of "
                         f"shared memory, over the {MAX_SMEM} B a block may "
                         f"use")

    winner = torch.empty((F, n_rows, cfg.view_width), dtype=torch.int32,
                         device=dev)
    best = torch.empty_like(winner) if with_best else None
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_trace_winners(
            pos.data_ptr(), ext.data_ptr(), sprite_id.data_ptr(),
            atlas_depth.data_ptr(), bins_ent.data_ptr(), counts.data_ptr(),
            players.data_ptr(), winner.data_ptr(),
            None if best is None else best.data_ptr(),
            F, cfg.view_width, cfg.view_height, cfg.bin_size, cap,
            cfg.hash_width, cfg.hash_height, cfg.hash_length,
            cfg.sprite_width, cfg.sprite_height, int(cfg.early_exit),
            row0 // cfg.bin_size, -(-n_rows // cfg.bin_size),
            block_threads(cfg), kernels.stream_handle(dev))
    kernels.check(rc, "par_trace_winners")
    launches += 1
    return (best, winner) if with_best else winner


def occupancy(config: RenderConfig) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of the kernel (needs the card)."""
    return kernels.occupancy("par_trace_occupancy", config,
                             block_threads(config))
