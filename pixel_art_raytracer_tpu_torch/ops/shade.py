"""Light geometry and the ambient + L1-Lambert shade on torch tensors.

Counterpart of ``pixel_art_raytracer_tpu/ops/shade.py`` (its non-integer
``light_geometry`` branch, ``factor_from_dot`` and the u8 scale) and of the
factor rules of the JAX batched path (``models/batched.py:888-905``): the
directional factor, which is ``factor_from_dot``'s op sequence with the
frame's constant direction, and the additive multi-light sum; and
:func:`point_frames`, :func:`light_frames` and :func:`directional_frames`,
the chains from the trace kernel's winners to the frames that the
winner-input point, multi-light and directional modes of
``csrc/shadow.cu`` run.  Float math
stays float32 in the reference's op order (alternative.cpp:702-760):

* the towards-light direction is ``d / len`` and the inverse direction is
  ``1 / (d / len)`` — two roundings, never ``len / d``;
* the Lambert dot is separate eager multiplies and adds, so nothing
  contracts into an FMA (no ``addcmul``, no ``torch.compile``);
* ``std::min``/``std::max`` keep their argument order under NaN.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from . import dither, shadow, shadow_dir, trace
from .cstyle import c_div, c_max, c_min
from .trace import GBufferArrays


def light_geometry(gbuf: GBufferArrays, lights: torch.Tensor,
                   config: RenderConfig):
    """Per-pixel shadow-ray geometry (alternative.cpp:707-732).

    lights: (F, 3) int32, one point light per frame.  Returns
    ``(tl, inv, origin, rb, lb)``: the L1-normalised towards-light direction,
    its reciprocal, the float ray origin and the ray's start bin, each a
    3-tuple of (F, H, W) tensors, and the light's bin, a 3-tuple of
    (F, 1, 1) int32 tensors.
    """
    cfg = config
    bs = cfg.bin_size
    f32 = torch.float32
    F = gbuf.y.shape[0]
    rb, origin = surface_rays(gbuf.y, gbuf.z, cfg)
    lx, ly, lz = (lights[:, a].view(F, 1, 1) for a in range(3))

    dx = lx.to(f32) - origin[0]
    dy = ly.to(f32) - origin[1]
    dz = lz.to(f32) - origin[2]
    # L1 normalisation (sprites.hpp:28-35, quirk Q2).
    length = dx.abs() + dy.abs() + dz.abs()
    tl = (dx / length, dy / length, dz / length)
    inv = tuple(torch.reciprocal(t) for t in tl)
    lb = (c_div(lx, bs), c_div(cfg.view_height - ly - lz, bs), c_div(lz, bs))
    return tl, inv, origin, rb, lb


def surface_rays(gbuf_y, gbuf_z, config: RenderConfig):
    """``(rb, origin)`` of the shadow rays from a G-buffer's surface points
    (alternative.cpp:724-732): the start bins ``(c_div(wx, bs),
    c_div(H - wy - wz, bs), c_div(wz, bs))`` int32 and the origins
    ``(wx, wy, wz)`` float32, each (F, H, W), with wx the pixel's column."""
    cfg = config
    bs = cfg.bin_size
    F, H, W = gbuf_y.shape
    wx = torch.arange(W, dtype=torch.int32,
                      device=gbuf_y.device).expand(F, H, W).contiguous()
    rb = (c_div(wx, bs), c_div(cfg.view_height - gbuf_y - gbuf_z, bs),
          c_div(gbuf_z, bs))
    origin = tuple(t.to(torch.float32) for t in (wx, gbuf_y, gbuf_z))
    return rb, origin


def lambert_dot(normal: torch.Tensor, tl) -> torch.Tensor:
    """``n . tl`` as ``n0*t0 + n1*t1 + n2*t2``, left to right."""
    return (normal[..., 0] * tl[0] + normal[..., 1] * tl[1]
            + normal[..., 2] * tl[2])


def factor_from_dot(dot, lit, config: RenderConfig) -> torch.Tensor:
    """min(1, max(0, dot) + ambient) where lit, ambient elsewhere
    (alternative.cpp:734-758).  The directional factor of the JAX batched
    path (``models/batched.py:888-895``) is the same op sequence, with the
    dot taken against the frame's constant direction."""
    ambient = config.ambient
    diffuse = c_max(torch.zeros_like(dot), dot)
    brightness = c_min(torch.ones_like(dot), diffuse + ambient)
    return torch.where(lit, brightness, torch.full_like(dot, ambient))


def add_light(diffuse, factor, config: RenderConfig) -> torch.Tensor:
    """One light's share of an additive multi-light frame:
    ``diffuse + maximum(factor - ambient, 0)`` (``models/batched.py:904``).
    NaN-propagating ``maximum``, as the JAX code's ``jnp.maximum``."""
    gain = factor - config.ambient
    return diffuse + torch.maximum(gain, torch.zeros_like(gain))


def multi_light_factor(diffuse, config: RenderConfig) -> torch.Tensor:
    """``minimum(1, ambient + diffuse)`` over the lights' summed diffuse
    (``models/batched.py:905``)."""
    total = config.ambient + diffuse
    return torch.minimum(torch.ones_like(total), total)


def shade_u8(color: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``Color * factor`` per RGB channel with C truncation to u8
    (sprites.hpp:8-16).  color (..., 4) uint8, factor (...)."""
    return (color[..., :3].to(torch.float32) * factor[..., None]).to(
        torch.uint8)


def point_frames(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                 atlas_normal, palette, bins_ent, counts, players, lights,
                 config: RenderConfig, frames: bool = True,
                 work: dict | None = None) -> torch.Tensor:
    """The frames of a point light per frame, from the trace kernel's
    winners: the plain version of ``csrc/shadow.cu``'s winner-input point
    mode (``ops/shadow_cuda.shade_point``).

    ``trace.decode_winner`` → :func:`light_geometry` →
    ``shadow.trace_light_dynamic`` (uncapped) → :func:`lambert_dot` and
    :func:`factor_from_dot` → :func:`shade_u8`, the G-buffer path's chain
    from a winner map.  winner: (F, H, W) int32, -1 for background; the
    scene's arrays as ``models/deferred.DeviceScene`` holds them; bins_ent
    (F, V, cap) and counts (F, V) int32; players and lights (F, 3) int32.
    Returns (F, H, W, 3) uint8 frames, or with ``frames=False`` the lit
    mask (F, H, W) bool.

    With frames, only the pixels whose colour the march can change are
    marched (:func:`march_live`), as the kernel does; the frames are the
    full chain's.  ``work`` receives the march's counts
    (``shadow.trace_light_dynamic``) over the pixels marched, and their
    number as ``work["marched_pixels"]`` (a 0-d int64 tensor).
    """
    y, z, ent, texel = trace.decode_winner(winner, pos, ext, sprite_id,
                                           atlas_depth, players, config)
    surface = GBufferArrays(normal=None, color=None, y=y, z=z,
                            entity_index=ent)
    tl, inv, origin, rb, lb = light_geometry(surface, lights, config)
    color, normal = trace.texel_attributes(winner >= 0, texel, atlas_color,
                                           atlas_normal, palette, config)
    dot = lambert_dot(normal, tl)
    live = march_live(dot, config) if frames else None
    lit = shadow.trace_light_dynamic(pos, ext, bins_ent, counts, rb, lb, ent,
                                     origin, inv, players, config, work=work,
                                     live=live)
    if work is not None:
        work["marched_pixels"] = (
            torch.tensor(lit.numel(), dtype=torch.int64, device=lit.device)
            if live is None else live.sum())
    if not frames:
        return lit
    return shade_u8(color, factor_from_dot(dot, lit, config))


def light_frames(winner, pos, ext, sprite_id, atlas_color, atlas_depth,
                 atlas_normal, palette, bins_ent, counts, players, lights,
                 config: RenderConfig,
                 work: dict | None = None) -> torch.Tensor:
    """The frames of L point lights per frame whose shadowed diffuse adds,
    from the trace kernel's winners: the plain version of
    ``csrc/shadow.cu``'s multi-light mode (``ops/shadow_cuda.shade_lights``).

    ``trace.decode_winner`` once; then for each light in order
    :func:`point_frames`' chain to its factor (:func:`light_geometry` →
    :func:`lambert_dot` → ``shadow.trace_light_dynamic`` over the pixels
    :func:`march_live` keeps → :func:`factor_from_dot`) and
    :func:`add_light`; then :func:`multi_light_factor` and
    :func:`shade_u8`: the G-buffer route's ``multi_light_stage`` and
    ``shade_stage`` from a winner map.  lights: (F, L, 3) int32, the
    frame's lights in the order their diffuse adds; the other arguments as
    :func:`point_frames`.  Returns (F, H, W, 3) uint8.  ``work`` receives
    the march's counts (``shadow.trace_light_dynamic``'s, ``slab_tests``
    among them) and its pixel-lights marched (``work["marched_pixels"]``),
    each summed over the lights (0-d int64 tensors).
    """
    y, z, ent, texel = trace.decode_winner(winner, pos, ext, sprite_id,
                                           atlas_depth, players, config)
    surface = GBufferArrays(normal=None, color=None, y=y, z=z,
                            entity_index=ent)
    color, normal = trace.texel_attributes(winner >= 0, texel, atlas_color,
                                           atlas_normal, palette, config)
    diffuse = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    totals = {"marched_pixels": torch.zeros((), dtype=torch.int64,
                                            device=y.device)}
    for li in range(lights.shape[1]):
        tl, inv, origin, rb, lb = light_geometry(
            surface, lights[:, li].contiguous(), config)
        dot = lambert_dot(normal, tl)
        live = march_live(dot, config)
        counted = {} if work is not None else None
        lit = shadow.trace_light_dynamic(pos, ext, bins_ent, counts, rb, lb,
                                         ent, origin, inv, players, config,
                                         work=counted, live=live)
        diffuse = add_light(diffuse, factor_from_dot(dot, lit, config),
                            config)
        if work is not None:
            counted["marched_pixels"] = live.sum()
            for k, v in counted.items():
                totals[k] = totals.get(k, 0) + v
    if work is not None:
        work.update(totals)
    return shade_u8(color, multi_light_factor(diffuse, config))


def march_live(dot: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """Where a point frame's colour depends on its shadow ray: the pixels
    whose factor lit (:func:`factor_from_dot`) differs from their factor
    occluded.  The others (with ambient <= 1 every background pixel, whose
    dot is 0 or NaN, and every face with a dot <= 0 or NaN; none with
    ambient > 1) have the same colour either way, so neither the
    winner-input point and directional modes' kernels nor
    :func:`point_frames` and :func:`directional_frames` march them (a
    directional frame's dot is taken against the frame's direction)."""
    lit = factor_from_dot(dot, torch.ones_like(dot, dtype=torch.bool),
                          config)
    occluded = factor_from_dot(dot, torch.zeros_like(dot, dtype=torch.bool),
                               config)
    return lit != occluded


def directional_frames(winner, pos, ext, sprite_id, atlas_color,
                       atlas_depth, atlas_normal, palette, bins_ent, counts,
                       players, tl, inv, K, config: RenderConfig,
                       style: str = "reference",
                       work: dict | None = None) -> torch.Tensor:
    """The frames of a directional light per frame, from the trace
    kernel's winners: the plain version of ``csrc/shadow.cu``'s
    winner-input directional mode (``ops/shadow_cuda.shade_directional``).

    ``trace.decode_winner`` → :func:`lambert_dot` against the frame's
    direction → ``shadow_dir.trace_light_directional`` (step cap
    ``shadow_dir.grid_max_steps``) → :func:`factor_from_dot` →
    :func:`shade_u8` (``style="reference"``) or ``dither.shade_dithered``
    onto the palette (``style="dithered"``, the whole view's rows): the
    G-buffer route's chain from a winner map.  tl, inv, K: (F, 3) of
    ``shadow_dir.direction_constants``; the other arguments as
    :func:`point_frames`.  Returns (F, H, W, 3) uint8.

    Only the pixels whose colour the march can change are marched
    (:func:`march_live`), as the kernel does; the frames are the full
    chain's.  ``work`` receives the march's counts
    (``shadow.trace_light_dynamic``) over the pixels marched, and their
    number as ``work["marched_pixels"]`` (a 0-d int64 tensor).
    """
    F = tl.shape[0]
    y, z, ent, texel = trace.decode_winner(winner, pos, ext, sprite_id,
                                           atlas_depth, players, config)
    color, normal = trace.texel_attributes(winner >= 0, texel, atlas_color,
                                           atlas_normal, palette, config)
    dot = lambert_dot(normal, tuple(tl[:, a].view(F, 1, 1)
                                    for a in range(3)))
    live = march_live(dot, config)
    lit = shadow_dir.trace_light_directional(
        pos, ext, bins_ent, counts, y, z, ent, inv, K, players, config,
        shadow_dir.grid_max_steps(config), work=work, live=live)
    if work is not None:
        work["marched_pixels"] = live.sum()
    factor = factor_from_dot(dot, lit, config)
    if style == "dithered":
        return dither.shade_dithered(color, factor, palette[:, :3])
    return shade_u8(color, factor)
