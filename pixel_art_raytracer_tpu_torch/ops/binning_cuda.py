"""Wrappers of the binning kernels (``csrc/binning.cu``), with no sort and
no host wait: the full rebin's per-bin tables of every frame
(:func:`bin_tables`), and the static cache's merge of its dynamic
entities into every frame's tables (:func:`merge_tables`).

``binning.bin_tables`` and ``StaticBins.merge`` route CUDA tensors here
and take the plain versions, :func:`binning.plain_tables` and
``StaticBins.plain_merge``, for CPU tensors; these wrappers only launch,
and raise for a tensor on any other device.  The count pass tiles the grid
by TILE_BINS bins, so no grid is too large for it.  ``launches`` counts the
full rebin's kernel launches (two a call: count, then place),
``merge_launches`` the merge's (one a call).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..runtime import kernels

launches = 0
merge_launches = 0

# csrc/binning.cu kChunk: entities a count block takes.
CHUNK = 1024
# csrc/binning.cu kTileBins: bins a count block takes, each an int32 count
# and a 32-bit group mask in shared memory (64 KB).
TILE_BINS = 8192
# csrc/binning.cu kMaxDynamic: dynamic entities a merge takes, one bit
# each in a bin's mask word.
MAX_DYNAMIC = 32


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


def merge_tables(static_total, static_ids, bins_static, counts_static,
                 dyn_pos, dyn_ext, config: RenderConfig,
                 spans: tuple[int, int, int]):
    """``(bins_ent (F, V, cap), counts (F, V))`` int32 of ``StaticBins.
    plain_merge``, computed by the kernel in one launch.

    static_total (V,), static_ids (V, cap + D), bins_static (V, cap),
    counts_static (V,): the cache's int32 tables, contiguous.  dyn_pos,
    dyn_ext: (F, D, 3) int32, entities [0, D) of each frame, read through
    their strides (an expanded view is not copied); D at most
    MAX_DYNAMIC.
    """
    global merge_launches
    dev = static_total.device
    kernels.require(dyn_pos, "dyn_pos", torch.int32, (None, None, 3), dev,
                    contiguous=False)
    F, D = dyn_pos.shape[:2]
    cfg = config
    V, cap = cfg.hash_volume, cfg.bin_capacity
    if not 1 <= D <= MAX_DYNAMIC:
        raise ValueError(f"merge_tables: {D} dynamic entities, the kernel "
                         f"takes 1 to {MAX_DYNAMIC}")
    for t, name, shape in ((static_total, "static_total", (V,)),
                           (static_ids, "static_ids", (V, cap + D)),
                           (bins_static, "bins_static", (V, cap)),
                           (counts_static, "counts_static", (V,))):
        kernels.require(t, name, torch.int32, shape, dev)
    kernels.require(dyn_ext, "dyn_ext", torch.int32, (F, D, 3), dev,
                    contiguous=False)
    if dev.type != "cuda":
        raise ValueError(f"merge_tables: no kernel for device {dev}")

    bins_ent = torch.empty((F, V, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((F, V), dtype=torch.int32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.par_bin_merge(
            dyn_pos.data_ptr(), dyn_ext.data_ptr(), static_total.data_ptr(),
            static_ids.data_ptr(), bins_static.data_ptr(),
            counts_static.data_ptr(), bins_ent.data_ptr(), counts.data_ptr(),
            F, D, *dyn_pos.stride(), *dyn_ext.stride(), cfg.view_width,
            cfg.view_height, cfg.view_length, cfg.bin_size, cfg.hash_width,
            cfg.hash_height, cfg.hash_length, *spans, cap,
            kernels.stream_handle(dev))
    kernels.check(rc, "par_bin_merge")
    merge_launches += 1
    return bins_ent, counts
