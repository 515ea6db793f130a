"""Spatial-hash binning on torch tensors.

Counterpart of ``pixel_art_raytracer_tpu/ops/binning.py``.  The reference
rebuilds its hash grid with a serial scatter loop (``count_entities_in_bins``,
alternative.cpp:195-269); here, as in the JAX package:

  1. enumerate (entity, covered-bin) pairs over a static per-entity offset
     grid (bound from the scene's largest extents),
  2. stable-sort the pairs by flat bin id, so pair order inside a bin is the
     reference's insertion order (entity-major, offsets x/y/z),
  3. rank pairs within their bin; the wrap-at-capacity overwrite (quirk Q3,
     alternative.cpp:259-264) keeps rank r iff r >= total - capacity, in
     slot r & (capacity-1), with visible count total & (capacity-1),
  4. one scatter (all surviving (bin, slot) targets are unique) builds the
     dense (hash_volume, capacity) table.

That chain is the plain version, which CPU tensors take.  On the card the
full rebin is ``csrc/binning.cu`` (``binning_cuda``): a histogram pass and
a placing pass with no sort and no host wait (:func:`bin_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..runtime import tracing
from . import binning_cuda
from .cstyle import c_div


def entity_span_bound(ext_max, config: RenderConfig) -> tuple[int, int, int]:
    """Static per-axis bound on how many bins one entity can cover.

    ``ext_max`` is the elementwise max extent over the scene.  The y range
    shears with z (screen space), so its bound uses ey + ez.
    """
    bs = config.bin_size
    ex, ey, ez = (int(v) for v in np.asarray(ext_max))
    return (ex // bs + 2, (ey + ez) // bs + 2, ez // bs + 2)


def covered_bins(pos: torch.Tensor, ext: torch.Tensor, config: RenderConfig,
                 spans: tuple[int, int, int]):
    """Flat ids of the bins each entity covers, over the static offset grid.

    pos, ext: (..., 3) int32.  Returns ``(flat, valid)``, each (..., K) with
    K = prod(spans), offsets lexicographic in (x, y, z) as the reference's
    scatter loop nests them (alternative.cpp:243-245).  Culled entities
    (alternative.cpp:212-219) and offsets past an entity's covered range
    are not valid.
    """
    cfg = config
    bs = cfg.bin_size
    vh = cfg.view_height
    x0, y0, z0 = pos.unbind(-1)
    ex, ey, ez = ext.unbind(-1)
    x1, y1, z1 = x0 + ex, y0 + ey, z0 + ez
    culled = ((x1 < 0) | (x0 >= cfg.view_width)
              | (y1 < -z1)
              | (y0 >= vh - z0 + bs)
              | (z1 < -ez - bs)
              | (z0 > cfg.view_length + bs))
    # Covered bin ranges with C-truncating division (alternative.cpp:222-240).
    min_xi = c_div(x0, bs).clamp(min=0)
    min_yi = c_div(vh - y1 - z1, bs).clamp(min=0)
    min_zi = c_div(z0, bs).clamp(min=0)
    max_xi = c_div(x1 + bs - 1, bs).clamp(max=cfg.hash_width)
    max_yi = c_div(vh - y0 - z0 + bs - 1, bs).clamp(max=cfg.hash_height)
    max_zi = c_div(z1 + bs - 1, bs).clamp(max=cfg.hash_length)

    oa, ob, oc = np.meshgrid(*(np.arange(s) for s in spans), indexing="ij")
    # Copies from pageable memory: on the card each waits for the stream.
    with tracing.span("sync.upload"):
        oa, ob, oc = (torch.as_tensor(o.reshape(-1), dtype=torch.int32,
                                      device=pos.device)
                      for o in (oa, ob, oc))
    bx = min_xi[..., None] + oa
    by = min_yi[..., None] + ob
    bz = min_zi[..., None] + oc
    valid = (~culled[..., None]
             & (bx < max_xi[..., None]) & (by < max_yi[..., None])
             & (bz < max_zi[..., None]))
    flat = (bx * cfg.hash_height + by) * cfg.hash_length + bz
    return flat, valid


def bin_totals_numpy(pos, ext, config: RenderConfig) -> np.ndarray:
    """Per-bin insertion totals before the wrap, (hash_volume,) int64, of
    (N, 3) numpy positions and extents, on the host.

    The port's copy of the JAX package's ``bin_totals_numpy``: the cull and
    covered-range enumeration of :func:`covered_bins` over the scene's own
    span bound, counted per flat bin, on CPU tensors whatever device
    renders (a static check of the scene, as ``parallel.envelope_ok``).
    """
    pos_t = torch.as_tensor(np.asarray(pos, np.int64))
    ext_t = torch.as_tensor(np.asarray(ext, np.int64))
    spans = entity_span_bound(ext_t.max(dim=0).values.numpy(), config)
    flat, valid = covered_bins(pos_t, ext_t, config, spans)
    return torch.bincount(flat[valid].long(),
                          minlength=config.hash_volume).numpy()


def ranked_pairs(pos: torch.Tensor, ext: torch.Tensor, config: RenderConfig,
                 spans: tuple[int, int, int]):
    """Covered (entity, bin) pairs stable-sorted by bin, with ranks.

    Returns ``(sorted_bin, pair_ent, rank, totals)``: per pair its flat bin
    (``hash_volume`` for invalid pairs, which sort last), its entity index,
    its rank among its bin's pairs in insertion order, and per bin
    (``hash_volume + 1`` entries) the number of insertions before the wrap.
    """
    V = config.hash_volume
    K = spans[0] * spans[1] * spans[2]
    flat, valid = covered_bins(pos, ext, config, spans)
    flat = torch.where(valid, flat, V).reshape(-1).long()

    # The stable sort keeps insertion order within each bin.
    order = torch.argsort(flat, stable=True)
    sorted_bin = flat[order]
    pair_ent = (order // K).to(torch.int32)

    idx = torch.arange(flat.numel(), device=pos.device)
    seg_start = torch.ones_like(sorted_bin, dtype=torch.bool)
    seg_start[1:] = sorted_bin[1:] != sorted_bin[:-1]
    rank = idx - torch.cummax(torch.where(seg_start, idx, 0), dim=0).values
    # bincount reads its input's range to size its output: on the card the
    # host waits for the sort and the scan above.
    with tracing.span("sync.bincount"):
        totals = torch.bincount(flat, minlength=V + 1)
    return sorted_bin, pair_ent, rank, totals


def plain_tables(pos: torch.Tensor, ext: torch.Tensor, players,
                 config: RenderConfig, spans: tuple[int, int, int],
                 window: int, ring: bool, id_offset: int = 0):
    """Each frame's per-bin tables keeping the last ``window`` ranks: the
    plain version of ``csrc/binning.cu``, on :func:`ranked_pairs`.

    Args:
      pos, ext: (N, 3) int32.
      players: (F, 3) int32, entity 0's position in each frame, or None
        for one frame as ``pos`` has it.
      spans: (Ax, Ay, Az) offset-grid bound from :func:`entity_span_bound`.
      window: the entries kept a bin.
      ring: the layout.  True is :func:`build_bins`' (``window`` a power
        of two, the capacity there: rank r in slot r & (window-1), the
        wrap of quirk Q3); False keeps the kept ranks left-aligned, as the
        static cache stores them (``static_bins``).
      id_offset: added to each stored entity index.

    Returns:
      ids: (F, V, window) int32, -1 for empty slots.
      counts: (F, V) int32 — the wrap-visible occupancy total & (window-1)
        in the ring layout, the insertion total otherwise.
    """
    binning_cuda.check_window(window, ring)
    frames = ([pos] if players is None else
              [torch.cat([players[f:f + 1], pos[1:]])
               for f in range(players.shape[0])])
    tables = [_window_tables(p, ext, config, spans, window, ring, id_offset)
              for p in frames]
    return (torch.stack([ids for ids, _ in tables]),
            torch.stack([counts for _, counts in tables]))


def _window_tables(pos, ext, config: RenderConfig, spans, window: int,
                   ring: bool, id_offset: int):
    V = config.hash_volume
    sorted_bin, pair_ent, rank, totals = ranked_pairs(pos, ext, config, spans)
    tot_here = totals[sorted_bin]
    keep = (sorted_bin < V) & (rank >= tot_here - window)
    if ring:
        slot = rank & (window - 1)
        counts = totals[:V] & (window - 1)
    else:
        # Bins with >= window entries store exactly their last ``window``
        # ranks; smaller bins store positions 0..total-1.
        slot = rank - (tot_here - window).clamp(min=0)
        counts = totals[:V]
    # Dropped pairs land in one spare slot past the table.
    target = torch.where(keep, sorted_bin * window + slot, V * window)
    ids = torch.full((V * window + 1,), -1, dtype=torch.int32,
                     device=pos.device)
    ids[target] = pair_ent + id_offset
    return ids[:V * window].reshape(V, window), counts.to(torch.int32)


def bin_tables(pos: torch.Tensor, ext: torch.Tensor, players,
               config: RenderConfig, spans: tuple[int, int, int],
               window: int, ring: bool, id_offset: int = 0):
    """:func:`plain_tables`' tables: on the card by ``csrc/binning.cu``
    (``binning_cuda.bin_tables``: two launches, no sort, no host wait), on
    the CPU by the plain version."""
    if pos.device.type == "cuda":
        return binning_cuda.bin_tables(pos, ext, players, config, spans,
                                       window, ring, id_offset)
    return plain_tables(pos, ext, players, config, spans, window, ring,
                        id_offset)


def build_bins(pos: torch.Tensor, ext: torch.Tensor, config: RenderConfig,
               spans: tuple[int, int, int]):
    """Rebuild the hash grid from every entity.

    Args:
      pos, ext: (N, 3) int32.
      spans: (Ax, Ay, Az) offset-grid bound from :func:`entity_span_bound`.

    Returns:
      bins_ent: (hash_volume, capacity) int32, -1 for empty slots.
      counts:   (hash_volume,) int32 — the wrap-visible occupancy.
    """
    bins_ent, counts = bin_tables(pos, ext, None, config, spans,
                                  config.bin_capacity, ring=True)
    return bins_ent[0], counts[0]
