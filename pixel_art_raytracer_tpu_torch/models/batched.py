"""Whole-batch renderer: the five stages of a frame, each over all F frames.

Counterpart of ``pixel_art_raytracer_tpu/models/batched.py::
render_states_batched``, cut down to its point-light reference path:

  1. bins     — ``StaticBins.merge`` of the player into every frame's
                tables (or a full rebuild per frame without a cache),
  2. trace    — kernel 1 → per-pixel winners (F, H, W) →
                ``materialize_gbuffer``,
  3. geometry — ``light_geometry`` and the Lambert dot,
  4. shadow   — kernel 2 → lit mask (F, H, W),
  5. shade    — ambient + Lambert factor → (F, H, W, 3) uint8.

With the renderer's ``fuse_trace_shadow`` set, stages 2-4 run as

  2-4. fused  — kernel 3 → winners and the lit mask (F, H, W) in one
                launch → ``materialize_gbuffer`` → ``light_geometry`` and
                the Lambert dot,

as the JAX package's fused path does after its kernel; the frames are the
same.  There is no fallback: a shape the fused kernel cannot take raises.

The stage functions are public so a profiler can time each one; the
reference's per-frame loop is alternative.cpp:628-817.  CUDA tensors run
the kernels, CPU tensors their plain versions.
"""

from __future__ import annotations

import torch

from ..ops import binning, fused_cuda, shade, shadow_cuda, trace, trace_cuda


def check_supported(renderer, lights: torch.Tensor, directional: bool,
                    upto) -> None:
    """Raise ``NotImplementedError`` for the JAX batched path's features
    that the port does not have yet, naming the ROADMAP item that ports
    each."""
    if directional:
        raise NotImplementedError(
            "directional lights are not ported yet (ROADMAP Queue 1 item "
            "8.3: ops/shadow_dir.py and shade.shade_directional)")
    if lights.dim() != 2:
        raise NotImplementedError(
            "multi-light (F, L, 3) frames are not ported yet (ROADMAP "
            "Queue 1 item 8.1: shade.shade_multi)")
    if renderer.style != "reference":
        raise NotImplementedError(
            f"style={renderer.style!r} is not ported yet (ROADMAP Queue 1 "
            "item 8.2: ops/dither.py)")
    if upto is not None:
        raise NotImplementedError(
            "upto= stage cuts are not ported; time the stage functions of "
            "models/batched.py instead")


def bin_stage(renderer, static_bins, dscene, players):
    """Per-frame bin tables: (F, V, cap) and (F, V) int32."""
    F = players.shape[0]
    if static_bins is not None:
        if static_bins.n_dynamic != 1:
            raise ValueError("the batched path moves entity 0 (the player) "
                             "only; build the cache with n_dynamic=1")
        return static_bins.merge(players[:, None, :],
                                 dscene.ext[:1].expand(F, 1, 3))
    tables = []
    for f in range(F):
        pos_f = dscene.pos.clone()
        pos_f[0] = players[f]
        tables.append(binning.build_bins(pos_f, dscene.ext, renderer.config,
                                         renderer.spans))
    return (torch.stack([b for b, _ in tables]),
            torch.stack([c for _, c in tables]))


def trace_stage(renderer, dscene, bins_ent, counts, players):
    """Primary visibility → G-buffer (``trace.GBufferArrays``)."""
    cfg = renderer.config
    winners = trace_cuda.trace_winners(
        dscene.pos, dscene.ext, dscene.sprite_id, dscene.atlas_depth,
        bins_ent, counts, players, cfg)
    return trace.materialize_gbuffer(
        winners, dscene.pos, dscene.ext, dscene.sprite_id,
        dscene.atlas_color, dscene.atlas_depth, dscene.atlas_normal,
        dscene.palette, players, cfg)


def geometry_stage(renderer, gbuf, lights):
    """Light geometry and the Lambert dot.  Returns ``(dot, inv, origin,
    rb, lb)``."""
    tl, inv, origin, rb, lb = shade.light_geometry(gbuf, lights,
                                                   renderer.config)
    return shade.lambert_dot(gbuf.normal, tl), inv, origin, rb, lb


def shadow_stage(renderer, dscene, bins_ent, counts, players, gbuf, inv,
                 origin, rb, lb):
    """Shadow march of every pixel → lit mask (F, H, W) bool."""
    return shadow_cuda.trace_light(dscene.pos, dscene.ext, bins_ent, counts,
                                   rb, lb, gbuf.entity_index, origin, inv,
                                   players, renderer.config)


def fused_stage(renderer, dscene, bins_ent, counts, players, lights):
    """Primary visibility and the shadow march in one kernel, then the
    G-buffer of the winners.  Returns ``(gbuf, winner, lit)``: the
    ``trace.GBufferArrays``, the winners (F, H, W) int32 (-1 background)
    and the lit mask (F, H, W) bool."""
    cfg = renderer.config
    _, winner, lit = fused_cuda.trace_shadow(
        dscene.pos, dscene.ext, dscene.sprite_id, dscene.atlas_depth,
        bins_ent, counts, players, lights, cfg)
    gbuf = trace.materialize_gbuffer(
        winner, dscene.pos, dscene.ext, dscene.sprite_id,
        dscene.atlas_color, dscene.atlas_depth, dscene.atlas_normal,
        dscene.palette, players, cfg)
    return gbuf, winner, lit


def shade_stage(renderer, gbuf, dot, lit):
    """Ambient + Lambert shade → (F, H, W, 3) uint8."""
    factor = shade.factor_from_dot(dot, lit, renderer.config)
    return shade.shade_u8(gbuf.color, factor)


def render_states_batched(renderer, static_bins, dscene, players, lights,
                          directional: bool = False,
                          upto: str | None = None) -> torch.Tensor:
    """Render F frames, one per (player, light) row.

    ``renderer``: a ``DeferredRenderer`` configured for the scene.
    ``static_bins``: a ``StaticBins`` cache with ``n_dynamic=1``, or None
    for a full rebuild per frame.  players, lights: (F, 3) int32 on the
    scene's device.  Returns (F, H, W, 3) uint8.

    ``directional``, (F, L, 3) lights, ``style="dithered"`` and ``upto``
    raise ``NotImplementedError``.
    """
    check_supported(renderer, lights, directional, upto)
    bins_ent, counts = bin_stage(renderer, static_bins, dscene, players)
    if renderer.fuse_trace_shadow:
        gbuf, _, lit = fused_stage(renderer, dscene, bins_ent, counts,
                                   players, lights)
        dot = geometry_stage(renderer, gbuf, lights)[0]
        return shade_stage(renderer, gbuf, dot, lit)
    gbuf = trace_stage(renderer, dscene, bins_ent, counts, players)
    dot, inv, origin, rb, lb = geometry_stage(renderer, gbuf, lights)
    lit = shadow_stage(renderer, dscene, bins_ent, counts, players, gbuf,
                       inv, origin, rb, lb)
    return shade_stage(renderer, gbuf, dot, lit)
