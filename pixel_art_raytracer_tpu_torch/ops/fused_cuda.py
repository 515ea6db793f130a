"""Wrapper of kernel 3 (``csrc/fused.cu``): winners and the lit mask in one
launch.

CPU tensors take the plain version, :func:`ops.fused.trace_shadow`; CUDA
tensors launch the kernel, and anything else raises.  ``launches`` counts
kernel launches; ``counters`` holds the kernel's device counters of its
march (as ``shadow_cuda.counters``).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels
from . import fused
from .shadow_cuda import MAX_SMEM, march_smem_bytes, march_threads
from .trace_cuda import band_pixels, draw_bytes

launches = 0
counters = kernels.MarchCounters()


def block_threads(config: RenderConfig) -> int:
    """Threads of a block, which walks and marches one band of the walk
    (:func:`trace_cuda.band_pixels`): 320 for 1,600-pixel bands."""
    return march_threads(config, band_pixels(config))


def smem_bytes(config: RenderConfig) -> int:
    """Shared memory of one block, which takes one band of a bin-column
    tile (:func:`trace_cuda.band_rows`): the bin column's staged
    candidates (hash_l * (1 + 8 * cap) ints), the surface point (y, z,
    entity) of each pixel of the band, which holds the walk's per-pixel
    state first, and one region for the march's visit lists and staged
    boxes (:func:`shadow_cuda.march_smem_bytes`) that holds the walk's draw
    list (:func:`trace_cuda.draw_bytes`) first."""
    cap = config.bin_capacity
    n_pix = band_pixels(config)
    return (4 * (config.hash_length * (1 + 8 * cap) + 3 * n_pix)
            + max(march_smem_bytes(config, pixels=n_pix), draw_bytes(config)))


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
    smem = smem_bytes(cfg)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_shadow: a column of {cfg.hash_length} x "
                         f"{cap} candidates, a band of {band_pixels(cfg)} "
                         f"pixels and visit lists of a {V}-bin grid need "
                         f"{smem} B of shared memory, over the {MAX_SMEM} B "
                         f"a block may use")

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
            block_threads(cfg), kernels.stream_handle(dev))
    kernels.check(rc, "par_fused_trace_shadow")
    launches += 1
    return best, winner, lit


def occupancy(config: RenderConfig) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of the kernel (needs the card)."""
    return kernels.occupancy("par_fused_occupancy", config,
                             block_threads(config))
