"""Primary visibility on torch tensors: the plain version of kernel 1.

Counterpart of ``pixel_art_raytracer_tpu/ops/trace.py``.  The reference
walks each pixel's bin column front to back (``trace_hash_for_pixel``,
alternative.cpp:271-397).  :func:`trace_winner` does the same for all
pixels of all frames at once, one (bin z, slot) candidate at a time, in the
reference order, which is observable through the strictly-greater depth
compare and the early exit.  It is what ``csrc/trace.cu`` computes, and what
``ops/trace_cuda.trace_winners`` runs for CPU tensors.

Every function takes frame-batched tables (leading axis F) and the
per-frame position of entity 0, the player (``players`` (F, 3)); entity 0's
row of ``pos`` is not read.  Each computes the whole view, or with
``rows=(row0, n_rows)`` a window of whole bin rows of it (a row shard of
``parallel/mesh.py``), shaped (F, n_rows, W): a pixel's walk reads only its
own bin column, so a window's pixels are the full frame's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..runtime import tracing

INT32_MIN = torch.iinfo(torch.int32).min


class GBufferArrays(NamedTuple):
    """SoA G-buffer (the reference's ``Pixel`` record, sprites.hpp:53-58),
    batched over frames."""

    normal: torch.Tensor        # (F, H, W, 3) float32
    color: torch.Tensor         # (F, H, W, 4) uint8
    y: torch.Tensor             # (F, H, W) int32
    z: torch.Tensor             # (F, H, W) int32
    entity_index: torch.Tensor  # (F, H, W) int32


def entity_pos(pos: torch.Tensor, players: torch.Tensor,
               ent: torch.Tensor) -> torch.Tensor:
    """``pos[ent]`` with entity 0 at its frame's position.

    ent: (F, ...) int32 entity ids (>= 0); players: (F, 3).  Returns
    (F, ..., 3) int32.
    """
    p = pos[ent.long()]
    pl = players.view((players.shape[0],) + (1,) * (ent.dim() - 1) + (3,))
    return torch.where((ent == 0)[..., None], pl, p)


def row_window(config: RenderConfig, rows=None) -> tuple[int, int]:
    """``(row0, n_rows)`` of a window of pixel rows ``rows``, None for the
    whole view.  A window is whole bin rows: ``row0`` and ``n_rows``
    multiples of the bin size.  Raises ``ValueError`` otherwise."""
    H, bs = config.view_height, config.bin_size
    if rows is None:
        return 0, H
    row0, n_rows = (int(v) for v in rows)
    end = row0 + n_rows
    if row0 < 0 or n_rows <= 0 or end > H or row0 % bs or n_rows % bs:
        raise ValueError(f"rows {row0}..{end - 1}: a window must be whole "
                         f"bin rows of {bs} pixels within the view's {H}")
    return row0, n_rows


def _pixel_grid(config: RenderConfig, device, rows=None):
    """Column index i (1, 1, W), row index j (1, n_rows, 1) of the window
    ``rows`` (:func:`row_window`) and the world row ``H - j``."""
    row0, n_rows = row_window(config, rows)
    i = torch.arange(config.view_width, dtype=torch.int32,
                     device=device)[None, None, :]
    j = torch.arange(row0, row0 + n_rows, dtype=torch.int32,
                     device=device)[None, :, None]
    return i, j, config.view_height - j


def _texel(sid, row, col, config: RenderConfig):
    """Clipped texel address into the flattened atlas (alternative.cpp:
    324-341)."""
    sh, sw = config.sprite_height, config.sprite_width
    return ((sid * sh + row.clamp(0, sh - 1)) * sw
            + col.clamp(0, sw - 1)).long()


def trace_winner(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                 players, config: RenderConfig, work: dict | None = None,
                 rows=None):
    """Per-pixel ``(best_depth, winner_entity)``, (F, H, W) int32 each
    ((F, n_rows, W) for a window ``rows``); winner -1 for background.

    Args:
      pos, ext: (N, 3) int32; sprite_id: (N,) int32.
      atlas_depth: (S, SH, SW) int32.
      bins_ent: (F, V, C) int32 (-1 empty); counts: (F, V) int32.
      players: (F, 3) int32 — entity 0's position per frame.
      work: when given, ``work["candidate_tests"]`` is set to the number
        of candidate hit tests the walk makes on these inputs, and
        ``work["candidate_hits"]`` to the number of those that pass the
        interval test (each a 0-d int64 tensor), for bounds on the
        kernel's time.
    """
    cfg = config
    dev = bins_ent.device
    F = bins_ent.shape[0]
    H, W = row_window(cfg, rows)[1], cfg.view_width
    cap = cfg.bin_capacity
    i, j, world_j = _pixel_grid(cfg, dev, rows)
    base_flat = ((i // cfg.bin_size) * cfg.hash_height
                 + j // cfg.bin_size) * cfg.hash_length
    frame = torch.arange(F, device=dev)[:, None, None]
    depth_flat = atlas_depth.reshape(-1)

    best = torch.full((F, H, W), INT32_MIN, dtype=torch.int32, device=dev)
    winner = torch.full((F, H, W), -1, dtype=torch.int32, device=dev)
    isect = torch.zeros((F, H, W), dtype=torch.int32, device=dev)
    broken = torch.zeros((F, H, W), dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for bz in range(cfg.hash_length):
        flat = (base_flat + bz).long()
        cnt = counts[frame, flat]
        active = ~broken
        if work is not None:
            tests += torch.where(active, cnt.clamp(max=cap), 0).sum()
        # An empty bin resets the adjacent-hit counter (alternative.cpp:
        # 297-300).
        isect = torch.where(active & (cnt == 0), 0, isect)
        bin_hit = torch.zeros((F, H, W), dtype=torch.bool, device=dev)
        for k in range(cap):
            valid = active & (k < cnt)
            ent = torch.where(valid, bins_ent[frame, flat, k], 0)
            apx, apy, apz = entity_pos(pos, players, ent).unbind(-1)
            aex, aey, aez = ext[ent.long()].unbind(-1)
            # Oblique interval test (alternative.cpp:310-317, quirk Q4).
            hit = (valid
                   & (i >= apx) & (i < apx + aex)
                   & (world_j > apy + apz)
                   & (world_j <= apy + aey + apz + aez))
            if work is not None:
                hits += hit.sum()
            row = apy + aey + apz + aez - world_j
            texel = _texel(sprite_id[ent.long()], row, i - apx, cfg)
            # Depth key (alternative.cpp:336-341); strictly greater wins,
            # so ties keep the earlier candidate.
            depth = apy - apz + (aey - row).clamp(max=0) - depth_flat[texel]
            improve = hit & (depth > best)
            best = torch.where(improve, depth, best)
            winner = torch.where(improve, ent, winner)
            bin_hit |= improve
        isect = isect + bin_hit.to(torch.int32)
        if cfg.early_exit:
            broken = broken | (active & (isect >= 2))
    if work is not None:
        work["candidate_tests"] = tests
        work["candidate_hits"] = hits
    return best, winner


def decode_winner(winner, pos, ext, sprite_id, atlas_depth, players,
                  config: RenderConfig, rows=None):
    """The surface point of each pixel's winner (of the window ``rows``).

    Returns ``(y, z, entity, texel)``, (F, H, W) each: the world y and z of
    the hit, the winner entity and its clipped atlas texel.  Background
    pixels (winner -1) take y = z = entity = 0 (quirk Q6) and entity 0's
    texel.
    """
    cfg = config
    i, _, world_j = _pixel_grid(cfg, winner.device, rows)
    hit = winner >= 0
    ent = torch.where(hit, winner, 0)
    apx, apy, apz = entity_pos(pos, players, ent).unbind(-1)
    _, aey, aez = ext[ent.long()].unbind(-1)
    row = apy + aey + apz + aez - world_j
    texel = _texel(sprite_id[ent.long()], row, i - apx, cfg)
    sdep = atlas_depth.reshape(-1)[texel]
    y = torch.where(hit, apy + aey + aez - row - sdep, 0)
    z = torch.where(hit, apz + sdep, 0)
    return y, z, ent, texel


def materialize_gbuffer(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                        atlas_normal, palette, players,
                        config: RenderConfig, rows=None) -> GBufferArrays:
    """Expand a per-pixel winner map (F, H, W) (or (F, n_rows, W) of the
    window ``rows``) into the G-buffer.

    Background pixels (winner -1) take the background color, a zero normal
    and zero y/z/entity fields (quirk Q6).
    """
    y, z, ent, texel = decode_winner(winner, pos, ext, sprite_id,
                                     atlas_depth, players, config, rows)
    color, normal = texel_attributes(winner >= 0, texel, atlas_color,
                                     atlas_normal, palette, config)
    return GBufferArrays(normal=normal, color=color, y=y, z=z,
                         entity_index=ent)


def texel_attributes(hit, texel, atlas_color, atlas_normal, palette,
                     config: RenderConfig):
    """``(color, normal)`` of each pixel's atlas ``texel``: the palette
    colour (..., 4) uint8 and the normal (..., 3) float32, or the
    background colour and a zero normal where ``hit`` is False."""
    cidx = atlas_color.reshape(-1)[texel]
    with tracing.span("sync.upload"):
        bg = torch.tensor(config.background, dtype=torch.uint8,
                          device=hit.device)
    color = torch.where(hit[..., None], palette[cidx.long()], bg)
    normal = torch.where(hit[..., None], atlas_normal.reshape(-1, 3)[texel],
                         0.0)
    return color, normal
