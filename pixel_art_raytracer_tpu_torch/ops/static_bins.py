"""Incremental binning: static-scene bin cache + per-frame dynamic merge.

Counterpart of ``pixel_art_raytracer_tpu/ops/static_bins.py``.  Only the
player (entity 0) moves, so the static entities are binned once and each
frame merges the few dynamic entities into the few bins they cover, giving
tables bit-identical to :func:`binning.build_bins` on the full scene.

Exactness argument (as in the JAX package): a bin's slot contents are
determined by each entry's rank in the bin's insertion sequence, which is
ordered by entity index.  The dynamic entities come first (indices
[0, n_dynamic)), so in every bin the dynamic entries precede the static
ones: a static entry's rank is its static rank plus the number of dynamic
entries in that bin, and a dynamic entry's rank is its index among the
dynamics covering the bin.  The wrap keeps ranks >= total - capacity in
slot ``rank & (capacity-1)`` with visible count ``total & (capacity-1)``
(quirk Q3), so it suffices to cache, per bin, the static total and the last
``capacity + n_dynamic`` static entries.

The JAX package writes the merged rows with select chains because scatters
are slow on the TPU; here the plain version (:meth:`StaticBins.plain_merge`,
which CPU tensors run) is plain scatters, and on the card the merge is one
launch of ``csrc/binning.cu``'s merge kernel (``binning_cuda.merge_tables``)
with no host wait.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..device import resolve
from . import binning, binning_cuda


class StaticBins:
    """Precomputed static-entity bin cache.

    Args:
      pos, ext: (N, 3) full scene arrays (numpy or tensors); entities
        [0, n_dynamic) are the movable ones and are excluded from the cache.
      n_dynamic: number of leading dynamic entities.
      device: where the cache lives (default: the card).
    """

    def __init__(self, pos, ext, n_dynamic: int, config: RenderConfig,
                 spans: tuple[int, int, int], *, device=None):
        self._set_meta(n_dynamic, config, spans)
        device = resolve(device)
        pos = torch.tensor(np.asarray(pos), dtype=torch.int32, device=device)
        ext = torch.tensor(np.asarray(ext), dtype=torch.int32, device=device)
        total, ids = _bin_statics(pos[n_dynamic:], ext[n_dynamic:],
                                  n_dynamic, config, spans, self.window)
        self._set_tables(total, ids)

    @classmethod
    def from_numpy(cls, static_total, static_ids, n_dynamic: int,
                   config: RenderConfig, spans: tuple[int, int, int], *,
                   device=None) -> "StaticBins":
        """A cache from the JAX package's ``StaticBins.static_total`` (V,)
        and ``static_ids`` (V, capacity + n_dynamic), as numpy arrays."""
        self = cls.__new__(cls)
        self._set_meta(n_dynamic, config, spans)
        device = resolve(device)
        self._set_tables(
            torch.tensor(np.asarray(static_total), dtype=torch.int32,
                         device=device),
            torch.tensor(np.asarray(static_ids), dtype=torch.int32,
                         device=device))
        return self

    def _set_meta(self, n_dynamic, config, spans):
        if n_dynamic < 1:
            raise ValueError("need at least one dynamic entity")
        self.config = config
        self.spans = tuple(spans)
        self.n_dynamic = n_dynamic
        self.window = config.bin_capacity + n_dynamic

    def _set_tables(self, static_total, static_ids):
        V = self.config.hash_volume
        if static_total.shape != (V,) or static_ids.shape != (V, self.window):
            raise ValueError(
                f"static tables {tuple(static_total.shape)}, "
                f"{tuple(static_ids.shape)} do not fit hash volume {V} "
                f"and window {self.window}")
        self.static_total = static_total
        self.static_ids = static_ids
        # Static-only slot layout: the merge result where no dynamic entity
        # covers a bin.
        self.bins_static = _static_rows(static_ids, static_total,
                                        torch.zeros_like(static_total),
                                        self.config.bin_capacity).contiguous()
        self.counts_static = static_total & (self.config.bin_capacity - 1)

    @property
    def device(self) -> torch.device:
        return self.static_total.device

    def merge(self, dyn_pos: torch.Tensor, dyn_ext: torch.Tensor):
        """Merge each frame's dynamic entities into the static tables.

        dyn_pos, dyn_ext: (F, n_dynamic, 3) int32.  Returns ``bins_ent``
        (F, V, capacity) and ``counts`` (F, V) int32, each frame
        bit-identical to ``binning.build_bins`` on the full scene: on the
        card by the merge kernel (one launch, no host wait; at most
        ``binning_cuda.MAX_DYNAMIC`` dynamic entities), on the CPU by
        :meth:`plain_merge`.
        """
        if dyn_pos.device.type == "cuda":
            return binning_cuda.merge_tables(
                self.static_total, self.static_ids, self.bins_static,
                self.counts_static, dyn_pos, dyn_ext, self.config,
                self.spans)
        return self.plain_merge(dyn_pos, dyn_ext)

    def plain_merge(self, dyn_pos: torch.Tensor, dyn_ext: torch.Tensor):
        """:meth:`merge`'s tables as a chain of tensor ops, on any device:
        the plain version of the merge kernel."""
        cfg = self.config
        cap = cfg.bin_capacity
        V = cfg.hash_volume
        dev = self.device
        F = dyn_pos.shape[0]
        K = self.spans[0] * self.spans[1] * self.spans[2]
        DK = self.n_dynamic * K

        flat, valid = binning.covered_bins(dyn_pos, dyn_ext, cfg, self.spans)
        flatf = torch.where(valid, flat, V).reshape(F, DK).long()
        validf = flatf < V
        flatc = flatf.clamp(max=V - 1)

        # Per covered pair: how many valid pairs share its bin (n_dyn), and
        # its dynamic rank (valid pairs of earlier entities, same bin).
        eq = (flatf[:, :, None] == flatf[:, None, :]) & validf[:, None, :]
        n_dyn = eq.sum(-1)
        d_of = torch.arange(DK, device=dev) // K
        rank_dyn = (eq & (d_of[None, :] < d_of[:, None])).sum(-1)

        st_total = self.static_total[flatc].long()
        total = st_total + n_dyn
        rows = _static_rows(self.static_ids[flatc], st_total, n_dyn, cap)

        # Dynamic overlay: pair jp writes entity d_of[jp] into slot
        # slot_dyn[jp] of every row of its bin.  Surviving ranks are
        # distinct, so no two writes of a row share a slot.
        keep_dyn = validf & (rank_dyn >= total - cap)
        place = eq & keep_dyn[:, None, :]
        slot = torch.where(place, (rank_dyn & (cap - 1))[:, None, :], cap)
        rows = torch.cat([rows, rows.new_full((F, DK, 1), -1)], dim=-1)
        rows.scatter_(-1, slot,
                      d_of.to(torch.int32).expand(F, DK, DK).contiguous())
        rows = rows[..., :cap]

        # Write the patched rows over per-frame copies of the static layout.
        # Pairs of one bin carry identical rows; invalid pairs go to one
        # spare row past the last frame.
        frame = torch.arange(F, device=dev)[:, None]
        target = torch.where(validf, frame * V + flatf, F * V).reshape(-1)
        bins_ent = torch.cat([self.bins_static.repeat(F, 1),
                              self.bins_static.new_full((1, cap), -1)])
        bins_ent[target] = rows.reshape(-1, cap)
        counts = torch.cat([self.counts_static.repeat(F),
                            self.counts_static.new_zeros(1)])
        counts[target] = (total & (cap - 1)).to(torch.int32).reshape(-1)
        return (bins_ent[:F * V].view(F, V, cap),
                counts[:F * V].view(F, V))


def _static_rows(stored, st_total, n_dyn, cap: int):
    """Slot rows for bins given their stored static ids, static totals and
    dynamic counts: the rank arithmetic of the wrap, as one scatter.

    stored (..., Ws) int32 (-1 padded), st_total (...), n_dyn (...) ->
    rows (..., cap) int32.
    """
    Ws = stored.shape[-1]
    stored_valid = stored >= 0
    stored_len = stored_valid.sum(-1)
    total = st_total + n_dyn
    i_idx = torch.arange(Ws, device=stored.device)
    rank_s = (st_total - stored_len + n_dyn)[..., None] + i_idx
    keep = stored_valid & (rank_s >= (total[..., None] - cap))
    slot = torch.where(keep, rank_s & (cap - 1), cap).long()
    rows = stored.new_full(stored.shape[:-1] + (cap + 1,), -1)
    rows.scatter_(-1, slot, stored)
    return rows[..., :cap]


def _bin_statics(pos, ext, id_offset: int, config: RenderConfig, spans,
                 window: int):
    """Bin static entities keeping the last ``window`` entries per bin.

    Returns ``static_total`` (V,) int32 and ``static_ids`` (V, window)
    int32: each bin's stored entries in rank order, left-aligned, -1 where
    the bin holds fewer than ``window`` (``binning.bin_tables``' left-aligned
    layout; on the card ``csrc/binning.cu``).
    """
    ids, total = binning.bin_tables(pos, ext, None, config, spans, window,
                                    ring=False, id_offset=id_offset)
    return total[0], ids[0]
