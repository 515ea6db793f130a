"""Wrapper of kernel 3 (``csrc/fused.cu``): winners and the lit mask in one
launch.

CPU tensors take the plain version, :func:`ops.fused.trace_shadow`; CUDA
tensors launch the kernel, and anything else raises.  ``launches`` counts
kernel launches; ``counters`` holds the kernel's device counters of its
march, the point march of ``shadow_cuda``'s point modes (as
``shadow_cuda.counters``).
"""

from __future__ import annotations

import functools

import torch

from ..config import RenderConfig
from ..runtime import kernels
from . import fused, shadow_cuda
from .shadow_cuda import MARCH_THREADS, MAX_SMEM
from .trace_cuda import band_rows, draw_bytes

launches = 0
counters = kernels.MarchCounters()


def smem_bytes(config: RenderConfig, chunk: int | None = None) -> int:
    """Shared memory of one block, which takes one band of a bin-column
    tile (:func:`trace_cuda.band_rows`), at ``chunk`` list entries staged
    at once (default: the most, up to ``shadow_cuda.SHADE_CHUNK``, at which
    4 blocks fit an SM): the point march's block
    (:func:`shadow_cuda.shade_smem_bytes`), whose head holds the walk's
    draw list (:func:`trace_cuda.draw_bytes`) first and whose per-pixel
    arrays the walk's state, rounded up to 4 bytes, then the bin column's
    staged candidates (hash_l * (1 + 8 * cap) ints)."""
    if chunk is None:
        chunk = _chunk(config)
    march = shadow_cuda.shade_smem_bytes(config, chunk,
                                         reserve=draw_bytes(config))
    return (-(-march // 4) * 4
            + 4 * config.hash_length * (1 + 8 * config.bin_capacity))


@functools.cache
def _chunk(config: RenderConfig) -> int:
    return shadow_cuda.shade_chunk(config,
                                   lambda chunk: smem_bytes(config, chunk))


def trace_shadow(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                 players, lights, config: RenderConfig,
                 with_best: bool = False):
    """``(best, winner, lit)``, each (F, H, W): int32 best depth (``None``
    unless ``with_best``), int32 winner entity (-1 for background) and the
    bool lit mask.

    Arguments as :func:`ops.fused.trace_shadow`.
    """
    global launches
    dev = bins_ent.device
    if dev.type == "cpu":
        best, winner, lit = fused.trace_shadow(
            pos, ext, sprite_id, atlas_depth, bins_ent, counts, players,
            lights, config)
        return (best if with_best else None), winner, lit
    if dev.type != "cuda":
        raise ValueError(f"trace_shadow: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    S = atlas_depth.shape[0]
    for t, name, dtype, shape in (
            (pos, "pos", torch.int32, (N, 3)),
            (ext, "ext", torch.int32, (N, 3)),
            (sprite_id, "sprite_id", torch.int32, (N,)),
            (atlas_depth, "atlas_depth", torch.int32,
             (S, cfg.sprite_height, cfg.sprite_width)),
            (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
            (counts, "counts", torch.int32, (F, V)),
            (players, "players", torch.int32, (F, 3)),
            (lights, "lights", torch.int32, (F, 3))):
        kernels.require(t, name, dtype, shape, dev)
    chunk = _chunk(cfg)
    smem = smem_bytes(cfg, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_shadow: the visit-list masks of a {V}-bin "
                         f"grid, a band of {band_rows(cfg)} rows of "
                         f"{cfg.bin_size} pixels and a column of "
                         f"{cfg.hash_length} x {cap} candidates need {smem} B "
                         f"of shared memory, over the {MAX_SMEM} B a block "
                         f"may use")

    winner = torch.empty((F, H, W), dtype=torch.int32, device=dev)
    best = torch.empty_like(winner) if with_best else None
    lit = torch.empty((F, H, W), dtype=torch.bool, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_fused_trace_shadow(
            pos.data_ptr(), ext.data_ptr(), sprite_id.data_ptr(),
            atlas_depth.data_ptr(), bins_ent.data_ptr(), counts.data_ptr(),
            players.data_ptr(), lights.data_ptr(), winner.data_ptr(),
            None if best is None else best.data_ptr(), lit.data_ptr(),
            counters.tensor(dev).data_ptr(), F, W, H, cfg.bin_size, cap,
            cfg.hash_width, cfg.hash_height, cfg.hash_length,
            cfg.sprite_width, cfg.sprite_height, int(cfg.early_exit),
            chunk, MARCH_THREADS, kernels.stream_handle(dev))
    kernels.check(rc, "par_fused_trace_shadow")
    launches += 1
    return best, winner, lit


def occupancy(config: RenderConfig) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of the kernel, at its chunk and threads
    (needs the card)."""
    return kernels.occupancy("par_fused_occupancy", config, MARCH_THREADS,
                             _chunk(config))
