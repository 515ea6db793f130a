"""Wrapper of kernel 2 (``csrc/shadow.cu``): the per-pixel lit mask.

CPU tensors take the plain version, :func:`ops.shadow.trace_light_dynamic`;
CUDA tensors launch the kernel, and anything else raises.  ``launches``
counts kernel launches; ``counters`` holds the kernel's device counters
(pixels marched directly, the most start bins in a tile, the longest visit
list).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels
from . import shadow

launches = 0
counters = kernels.MarchCounters()

# Shared memory a block may use on Hopper (opt-in above 48 KB).
MAX_SMEM = 227 * 1024
# csrc/common.cuh: kStarts, the distinct start bins a tile's table holds;
# kChunkBins, the list entries staged at once; kMarchThreads, the most
# threads a march block may have.
STARTS = 4
CHUNK_BINS = 64
MARCH_THREADS = 320


def march_threads(config: RenderConfig) -> int:
    """Threads of a march block (one bin-column tile of bin_size**2
    pixels): the largest warp multiple up to MARCH_THREADS that divides the
    pixels (320 for 40x40 tiles), else 256."""
    n_pix = config.bin_size * config.bin_size
    return next((t for t in range(MARCH_THREADS, 31, -32)
                 if n_pix % t == 0), 256)


def march_smem_bytes(config: RenderConfig) -> int:
    """Shared memory of csrc/common.cuh ``MarchSmem`` for one tile of
    bin_size**2 pixels: CHUNK_BINS staged list entries of ``cap``
    candidates (two float4: the corners and the raw id) and their live
    counts, the tile's start bins, list lengths and table counts, each
    warp's start bins and their index in the table, a V-bit mask and a
    V-entry visit list per start bin, and two bytes a pixel."""
    V, cap = config.hash_volume, config.bin_capacity
    n_pix = config.bin_size ** 2
    warps = MARCH_THREADS // 32
    ints = (8 * CHUNK_BINS * cap + CHUNK_BINS + STARTS * 3 + STARTS + 2
            + warps * (STARTS * 3 + 1 + STARTS) + STARTS * -(-V // 32)
            + STARTS * V + (2 * n_pix + 3) // 4)
    return 4 * ints


def trace_light(pos, ext, bins_ent, counts, start_bin, end_bin, start_ent,
                origin, inv_dir, players,
                config: RenderConfig) -> torch.Tensor:
    """Lit mask (F, H, W) bool: True where the light is reachable.

    Arguments as :func:`ops.shadow.trace_light_dynamic`; ``end_bin`` holds
    one light bin per frame, each component of shape (F, 1, 1).
    """
    global launches
    dev = bins_ent.device
    if dev.type == "cpu":
        return shadow.trace_light_dynamic(pos, ext, bins_ent, counts,
                                          start_bin, end_bin, start_ent,
                                          origin, inv_dir, players, config)
    if dev.type != "cuda":
        raise ValueError(f"trace_light: no kernel for device {dev}")

    cfg = config
    F = bins_ent.shape[0]
    H, W = cfg.view_height, cfg.view_width
    V, cap = cfg.hash_volume, cfg.bin_capacity
    N = pos.shape[0]
    light_bin = torch.stack([b.reshape(F) for b in end_bin], dim=1)
    pixel = (F, H, W)
    checks = [
        (pos, "pos", torch.int32, (N, 3)),
        (ext, "ext", torch.int32, (N, 3)),
        (players, "players", torch.int32, (F, 3)),
        (bins_ent, "bins_ent", torch.int32, (F, V, cap)),
        (counts, "counts", torch.int32, (F, V)),
        (start_ent, "start_ent", torch.int32, pixel),
        (light_bin, "light_bin", torch.int32, (F, 3)),
    ]
    checks += [(t, f"start_bin[{a}]", torch.int32, pixel)
               for a, t in enumerate(start_bin)]
    checks += [(t, f"origin[{a}]", torch.float32, pixel)
               for a, t in enumerate(origin)]
    checks += [(t, f"inv_dir[{a}]", torch.float32, pixel)
               for a, t in enumerate(inv_dir)]
    for t, name, dtype, shape in checks:
        kernels.require(t, name, dtype, shape, dev)
    smem = march_smem_bytes(cfg)
    if smem > MAX_SMEM:
        raise ValueError(f"trace_light: visit lists of a {V}-bin grid and "
                         f"a tile of {cfg.bin_size}**2 pixels need {smem} B "
                         f"of shared memory, over the {MAX_SMEM} B a block "
                         f"may use")

    lit = torch.empty(pixel, dtype=torch.bool, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_shadow_lit(
            pos.data_ptr(), ext.data_ptr(), players.data_ptr(),
            bins_ent.data_ptr(), counts.data_ptr(),
            *(t.data_ptr() for t in start_bin),
            *(t.data_ptr() for t in origin),
            *(t.data_ptr() for t in inv_dir),
            start_ent.data_ptr(), light_bin.data_ptr(), lit.data_ptr(),
            counters.tensor(dev).data_ptr(),
            F, W, H, cfg.bin_size, cap, cfg.hash_width, cfg.hash_height,
            cfg.hash_length, march_threads(cfg), kernels.stream_handle(dev))
    kernels.check(rc, "par_shadow_lit")
    launches += 1
    return lit


def occupancy(config: RenderConfig) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of the kernel (needs the card)."""
    return kernels.occupancy("par_shadow_occupancy", config,
                             march_threads(config))
