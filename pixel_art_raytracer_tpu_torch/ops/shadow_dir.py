"""Directional lights on torch tensors: the per-frame constants, the
per-pixel virtual far-light bins and the plain version of the directional
shadow march.

Counterpart of ``pixel_art_raytracer_tpu/ops/shadow_dir.py`` (the parts the
Hopper kernel needs) and of the march of ``ops/shade.py::shade_directional``
there.  A directional light is a light far along the direction: each pixel
marches toward its own virtual far light, whose bin is
``c_div(coord + K_axis, bin_size)`` with the per-frame offsets
``K = trunc(tl * span)``, for at most ``grid_max_steps`` DDA steps.  The
march is ``ops/shadow.trace_light_dynamic`` with per-pixel light bins and
that step cap; ``csrc/shadow.cu``'s directional mode computes it.

The JAX package's extended start space (``extended_tables``,
``axis_bases``, ``membership_words_dir``, ``lane_rows_and_matrix``,
``pixel_rows``, ``bg_row``) feeds the TPU kernel's membership tables and has
no counterpart: the Hopper kernel keys its tile table by (start bin, light
bin), packed into one word by :func:`key_fields`, and marches each tile over
one union of its keys' visit lists, which :func:`tile_unions` counts.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from . import shade
from .cstyle import c_div
from .shadow import dda_first_visits, trace_light_dynamic

# The keys a tile's table of the directional kernel holds
# (csrc/shadow.cu kDirKeys): a key is a bit of each bin's mask.
TABLE_KEYS = 16
# Bits a packed key may take: the all-ones word marks an empty slot of the
# kernel's table.
KEY_BITS = 63


def grid_max_steps(config: RenderConfig) -> int:
    """``shade_directional``'s step cap: a ray that starts in the grid
    leaves it after at most this many thick-DDA steps."""
    return (config.hash_width + config.hash_height + 1
            + config.hash_length)


def direction_constants(directions: torch.Tensor, config: RenderConfig):
    """Per-frame constants of (F, 3) float32 directions toward the light.

    Returns ``(tl, inv, K)``, each (F, 3): the L1-normalised direction
    ``d / (|d0| + |d1| + |d2|)`` (float32, summed left to right), its
    reciprocal ``1 / tl`` (two roundings, as the reference's geometry) and
    the far-light offsets ``trunc(tl * span)`` (int32), with ``span`` twice
    the largest view dimension.
    """
    cfg = config
    d = directions.to(torch.float32)
    length = d[:, 0].abs() + d[:, 1].abs() + d[:, 2].abs()
    tl = d / length[:, None]
    inv = torch.reciprocal(tl)
    span = max(cfg.view_width, cfg.view_height, cfg.view_length) * 2
    K = (tl * span).to(torch.int32)
    return tl, inv, K


def pixel_light_bins(gbuf_y, gbuf_z, K, config: RenderConfig):
    """Per-pixel virtual far-light bins ``(lbx, lby, lbz)``, each (F, H, W)
    int32, from the G-buffer's y, z (F, H, W) int32 and the (F, 3) offsets
    ``K``: ``c_div(wx + Kx, bs)``, ``c_div(H - wy - wz - (Ky + Kz), bs)``,
    ``c_div(wz + Kz, bs)``, with wx the pixel's column."""
    cfg = config
    bs = cfg.bin_size
    F, H, W = gbuf_y.shape
    Kx, Ky, Kz = (K[:, a].view(F, 1, 1) for a in range(3))
    wx = torch.arange(W, dtype=torch.int32, device=gbuf_y.device)
    lbx = c_div((wx + Kx).expand(F, H, W), bs)
    lby = c_div(cfg.view_height - gbuf_y - gbuf_z - (Ky + Kz), bs)
    lbz = c_div(gbuf_z + Kz, bs)
    return lbx, lby, lbz


def trace_light_directional(pos, ext, bins_ent, counts, gbuf_y, gbuf_z,
                            start_ent, inv, K, players,
                            config: RenderConfig, max_steps: int,
                            work: dict | None = None,
                            live: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Lit mask (F, H, W) bool of a directional light per frame: the plain
    version of ``csrc/shadow.cu``'s directional mode.

    gbuf_y, gbuf_z, start_ent: (F, H, W) int32 surface points and own
    entities; inv, K: (F, 3) float32 and int32 from
    :func:`direction_constants`; max_steps: the step cap
    (:func:`grid_max_steps` on the render path).  Other arguments,
    ``work`` and ``live`` (the rays to march, None for all) as
    :func:`ops.shadow.trace_light_dynamic`, which this is with the rays of
    ``ops/shade.surface_rays`` and the light bins of
    :func:`pixel_light_bins`.
    """
    F = gbuf_y.shape[0]
    rb, origin = shade.surface_rays(gbuf_y, gbuf_z, config)
    lb = pixel_light_bins(gbuf_y, gbuf_z, K, config)
    inv_b = tuple(inv[:, a].reshape(F, 1, 1) for a in range(3))
    return trace_light_dynamic(pos, ext, bins_ent, counts, rb, lb,
                               start_ent, origin, inv_b, players, config,
                               work=work, max_steps=max_steps, live=live)


def _bits(values: int) -> int:
    """Bits that hold ``values`` distinct values."""
    return max(1, (values - 1).bit_length())


def key_fields(config: RenderConfig) -> tuple[tuple[int, int], ...]:
    """``(lo, bits)`` of each field of the directional kernel's packed key
    (csrc/shadow.cu ``KeyFields``), in order: the start bin's y and z, and
    the light bin minus the start bin in x, y and z.  A field holds
    ``value - lo`` in ``bits`` bits; the start bin's x is the tile's.

    The ranges cover every pixel of the render path.  The start bin's y,
    ``c_div(view_h - y - z, bs)``, is the pixel's bin row for a hit
    (y + z = view_h - row) and ``c_div(view_h, bs)`` for the background
    (y = z = 0): 0 .. hash_height.  Its z, ``c_div(z, bs)``, covers surface
    points from a grid length before the grid to a grid length past it.
    The far light lies ``K = trunc(tl * span)`` away, with |K| <= span on
    each axis (``span`` of :func:`direction_constants`), so the light bin
    is at most ``span // bs + 1`` bins from the start bin in x and z, and
    ``2 * span // bs + 1`` in y (which takes Ky + Kz).  The kernel marches a
    pixel whose key falls outside on its own.

    Raises ``ValueError`` when the fields take more than :data:`KEY_BITS`
    bits together, or one field more than 31.
    """
    cfg = config
    bs = cfg.bin_size
    span = max(cfg.view_width, cfg.view_height, cfg.view_length) * 2
    reach = span // bs + 1
    fields = ((0, cfg.hash_height + 1),
              (-cfg.hash_length, 3 * cfg.hash_length + 1),
              (-reach, 2 * reach + 1),
              (-(2 * span // bs + 1), 2 * (2 * span // bs + 1) + 1),
              (-reach, 2 * reach + 1))
    out = tuple((lo, _bits(n)) for lo, n in fields)
    total = sum(b for _, b in out)
    if total > KEY_BITS or max(b for _, b in out) > 31:
        raise ValueError(
            f"key_fields: a directional key of {cfg} needs fields of "
            f"{[b for _, b in out]} bits ({total} in all), over the "
            f"{KEY_BITS} bits of a packed key or 31 of one field")
    return out


def tile_unions(gbuf_y, gbuf_z, K, config: RenderConfig, max_steps: int,
                live: torch.Tensor | None = None) -> dict[str, int]:
    """What the directional kernel builds in its tiles on these inputs
    (``gbuf_y``, ``gbuf_z`` (F, H, W) int32, ``K`` (F, 3) int32), counted
    with :func:`ops.shadow.dda_first_visits` over each (frame, bin-column
    tile)'s distinct (start bin, light bin) keys, of the pixels whose key
    fits :func:`key_fields` and, where ``live`` (F, H, W) bool is given,
    that it holds (the winner-input mode keys only the pixels
    ``ops/shade.march_live`` keeps):

    - ``keys``: the most keys in a tile;
    - ``staged``: the union entries, each distinct bin of a tile's keys'
      visit lists once, summed over the tiles (what the kernel stages);
    - ``key_entries``: the visit lists' entries, summed over the tiles'
      keys (what a march over per-key lists stages);
    - ``largest``: the largest union of a tile;
    - ``longest``: the longest visit list.

    Exact for the kernel where ``keys`` <= :data:`TABLE_KEYS`; a tile with
    more marches the keys past the table's on their own.
    """
    cfg = config
    bs = cfg.bin_size
    F, H, W = gbuf_y.shape
    dev = gbuf_y.device
    rb, _ = shade.surface_rays(gbuf_y, gbuf_z, cfg)
    lb = pixel_light_bins(gbuf_y, gbuf_z, K, cfg)
    values = (rb[1], rb[2], lb[0] - rb[0], lb[1] - rb[1], lb[2] - rb[2])
    fits = torch.ones_like(gbuf_y, dtype=torch.bool)
    for v, (lo, bits) in zip(values, key_fields(cfg)):
        fits &= (v >= lo) & (v < lo + (1 << bits))
    if live is not None:
        fits &= live
    frame = torch.arange(F, device=dev).view(F, 1, 1)
    row = torch.arange(H, device=dev).view(1, H, 1) // bs
    col = torch.arange(W, device=dev).view(1, 1, W) // bs
    tile = ((frame * cfg.hash_width + col) * cfg.hash_height
            + row).expand(F, H, W)
    pairs = torch.stack([tile, *rb, *lb], dim=-1)[fits].long()
    pairs = torch.unique(pairs, dim=0)  # (tile, start bin, light bin)
    if pairs.shape[0] == 0:
        return dict.fromkeys(("keys", "staged", "key_entries", "largest",
                              "longest"), 0)
    flats, first = dda_first_visits(
        tuple(pairs[:, a].int() for a in (1, 2, 3)),
        tuple(pairs[:, a].int() for a in (4, 5, 6)), cfg, max_steps)
    tiles = pairs[:, 0].expand_as(flats)[first]
    union = torch.unique(tiles * (cfg.hash_volume + 1) + flats[first])
    return {"keys": int(torch.bincount(pairs[:, 0]).max()),
            "staged": union.numel(),
            "key_entries": int(first.sum()),
            "largest": int(torch.unique(union // (cfg.hash_volume + 1),
                                        return_counts=True)[1].max()),
            "longest": int(first.sum(0).max())}
