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
bin) instead.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from .cstyle import c_div
from .shade import surface_rays
from .shadow import trace_light_dynamic


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
                            work: dict | None = None) -> torch.Tensor:
    """Lit mask (F, H, W) bool of a directional light per frame: the plain
    version of ``csrc/shadow.cu``'s directional mode.

    gbuf_y, gbuf_z, start_ent: (F, H, W) int32 surface points and own
    entities; inv, K: (F, 3) float32 and int32 from
    :func:`direction_constants`; max_steps: the step cap
    (:func:`grid_max_steps` on the render path).  Other arguments and
    ``work`` as :func:`ops.shadow.trace_light_dynamic`, which this is with
    the rays of ``ops/shade.surface_rays`` and the light bins of
    :func:`pixel_light_bins`.
    """
    F = gbuf_y.shape[0]
    rb, origin = surface_rays(gbuf_y, gbuf_z, config)
    lb = pixel_light_bins(gbuf_y, gbuf_z, K, config)
    inv_b = tuple(inv[:, a].reshape(F, 1, 1) for a in range(3))
    return trace_light_dynamic(pos, ext, bins_ent, counts, rb, lb,
                               start_ent, origin, inv_b, players, config,
                               work=work, max_steps=max_steps)
