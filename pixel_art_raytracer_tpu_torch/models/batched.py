"""Whole-batch renderer: the stages of a frame, each over all F frames.

Counterpart of ``pixel_art_raytracer_tpu/models/batched.py::
render_states_batched``.  A point light per frame in ``style="reference"``
(the main path) runs

  1. bins     — ``StaticBins.merge`` of the player into every frame's
                tables (or a full rebuild per frame without a cache),
  2. trace    — kernel 1 → per-pixel winners (F, H, W),
  3. shade    — kernel 2's winner-input point mode: each pixel's surface
                point and shadow ray derived from its winner, the march,
                and the ambient + Lambert shade of the palette colour, in
                the kernel → (F, H, W, 3) uint8 (:func:`shade_point_stage`),

as the JAX package's batched path does by default with its winner-direct
shadow inputs (``models/batched.py:133-141`` there) and, here, its shade
epilogue (``shadow_pallas.py:1140-1216``): no G-buffer, ray buffer, lit
mask or dot reaches device memory.

The other requests keep the G-buffer, each by the JAX package's own path
choice: the callers that hand the G-buffer back (``gbuffer_and_frames``:
``DeferredRenderer.render_with_gbuffer``, hence the session, the viewer and
single frames) and the row windows of ``parallel/mesh.py``, the
directional mode (the JAX winner mode excludes it), additive multi-light
and the dithered style (the JAX shade epilogue excludes both: they need
per-light lit masks or re-quantise), and the fused opt-in (the JAX fused
kernel has no shade epilogue).  Their point lights run

  2. trace    — kernel 1 → winners → ``materialize_gbuffer``,
  3. geometry — ``light_geometry`` and the Lambert dot,
  4. shadow   — kernel 2 → lit mask (F, H, W),
  5. shade    — the ambient + Lambert factor, then the u8 scale of the
                palette colour (``style="reference"``) or the ordered dither
                onto the palette (``style="dithered"``) → (F, H, W, 3) uint8.

With the renderer's ``fuse_trace_shadow`` set, stages 2-4 run as

  2-4. fused  — kernel 3 → winners and the lit mask (F, H, W) in one
                launch → ``materialize_gbuffer`` → ``light_geometry`` and
                the Lambert dot,

as the JAX package's fused path does after its kernel; the frames are the
same.  There is no fallback: a shape the fused kernel cannot take raises.

The other lighting modes replace stages 3-4, as the JAX package's batched
path does (``models/batched.py:888-905`` there):

* additive multi-light, (F, L, 3) lights: stages 3-4 run once per light
  (L launches of kernel 2) and each light's shadowed diffuse adds over the
  shared ambient base (:func:`multi_light_stage`);
* directional lights, ``directional=True`` with (F, 3) float32 directions
  toward the light: the frame's constant direction gives the Lambert dot,
  and kernel 2's directional mode marches each pixel toward its own
  virtual far light under the grid's step cap (:func:`directional_stage`).

The JAX package runs its fused kernel only for (F, 3) point lights
(``models/batched.py:161-172`` there), so multi-light and directional
frames take the two-kernel path whatever ``fuse_trace_shadow`` says, and
so does the port: this is the JAX package's path choice, not a fallback
on failure.  The dithered style applies to every mode, after its factor.

A row shard of ``parallel/mesh.py`` passes ``rows=(row0, n_rows)``, a
window of whole bin rows: its stages trace, march and shade that window's
pixels only, for (F, n_rows, W, 3) frames.  It takes the two-kernel path
for point lights, as the JAX package's row shards call ``trace`` and
``shade``; directional lights take no window.

The stage functions are public so a profiler can time each one, and each
runs in a span of ``runtime/tracing.py`` (``batch.bins``, ``batch.trace``,
...) inside one ``batch`` span a request; the reference's per-frame loop
is alternative.cpp:628-817.  CUDA tensors run the kernels, CPU tensors
their plain versions.
"""

from __future__ import annotations

import torch

from ..ops import (binning, dither, fused_cuda, shade, shadow_cuda,
                   shadow_dir, trace, trace_cuda)
from ..runtime import tracing


def check_supported(lights: torch.Tensor, directional: bool, upto) -> None:
    """Raise for a request the batched path does not render: ``upto=``
    stage cuts (``NotImplementedError``), and directional lights given as
    (F, L, 3) (``ValueError``, as in the JAX package)."""
    if upto is not None:
        raise NotImplementedError(
            "upto= stage cuts are not ported; time the stage functions of "
            "models/batched.py instead")
    if directional and lights.dim() != 2:
        raise ValueError("directional mode takes (F, 3) directions, not "
                         f"lights of shape {tuple(lights.shape)}")
    if lights.dim() not in (2, 3) or lights.shape[-1] != 3:
        raise ValueError(f"lights of shape {tuple(lights.shape)}: expected "
                         f"(F, 3) or (F, L, 3)")


@tracing.spanned("batch.bins")
def bin_stage(renderer, static_bins, dscene, players):
    """Per-frame bin tables: (F, V, cap) and (F, V) int32."""
    F = players.shape[0]
    if static_bins is not None:
        if static_bins.n_dynamic != 1:
            raise ValueError("the batched path moves entity 0 (the player) "
                             "only; build the cache with n_dynamic=1")
        return static_bins.merge(players[:, None, :],
                                 dscene.ext[:1].expand(F, 1, 3))
    # The full rebin of every frame, entity 0 at players[f]: one call of
    # csrc/binning.cu on the card.
    return binning.bin_tables(dscene.pos, dscene.ext, players,
                              renderer.config, renderer.spans,
                              renderer.config.bin_capacity, ring=True)


@tracing.spanned("batch.trace")
def winner_stage(renderer, dscene, bins_ent, counts, players, rows=None):
    """Primary visibility: the winners (F, H, W) int32 (-1 background) of
    the view or of the window ``rows``."""
    return trace_cuda.trace_winners(
        dscene.pos, dscene.ext, dscene.sprite_id, dscene.atlas_depth,
        bins_ent, counts, players, renderer.config, rows=rows)


@tracing.spanned("batch.trace")
def trace_stage(renderer, dscene, bins_ent, counts, players, rows=None):
    """Primary visibility → G-buffer (``trace.GBufferArrays``) of the view
    or of the window ``rows``."""
    # winner_stage's body: one batch.trace span.
    winners = winner_stage.__wrapped__(renderer, dscene, bins_ent, counts,
                                       players, rows)
    return trace.materialize_gbuffer(
        winners, dscene.pos, dscene.ext, dscene.sprite_id,
        dscene.atlas_color, dscene.atlas_depth, dscene.atlas_normal,
        dscene.palette, players, renderer.config, rows=rows)


@tracing.spanned("batch.shade")
def shade_point_stage(renderer, dscene, bins_ent, counts, players, winners,
                      lights):
    """The frames of (F, 3) point lights from the winners, in kernel 2's
    winner-input point mode (surface, shadow ray, march and shade in one
    launch).  Returns (F, H, W, 3) uint8."""
    return shadow_cuda.shade_point(
        winners, dscene.pos, dscene.ext, dscene.sprite_id,
        dscene.atlas_color, dscene.atlas_depth, dscene.atlas_normal,
        dscene.palette, bins_ent, counts, players, lights, renderer.config)


@tracing.spanned("batch.geometry")
def geometry_stage(renderer, gbuf, lights):
    """Light geometry and the Lambert dot.  Returns ``(dot, inv, origin,
    rb, lb)``."""
    tl, inv, origin, rb, lb = shade.light_geometry(gbuf, lights,
                                                   renderer.config)
    return shade.lambert_dot(gbuf.normal, tl), inv, origin, rb, lb


@tracing.spanned("batch.shadow")
def shadow_stage(renderer, dscene, bins_ent, counts, players, gbuf, inv,
                 origin, rb, lb, rows=None):
    """Shadow march of every pixel (of the window ``rows``) → lit mask
    (F, H, W) bool."""
    return shadow_cuda.trace_light(dscene.pos, dscene.ext, bins_ent, counts,
                                   rb, lb, gbuf.entity_index, origin, inv,
                                   players, renderer.config, rows=rows)


@tracing.spanned("batch.fused")
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


@tracing.spanned("batch.lights")
def multi_light_stage(renderer, dscene, bins_ent, counts, players, gbuf,
                      lights, rows=None):
    """Stages 3-4 once per light of (F, L, 3) int32 ``lights``, each
    light's factor accumulated as ``shade.add_light``, then
    ``shade.multi_light_factor``.  Returns the factor (F, H, W) float32."""
    cfg = renderer.config
    diffuse = torch.zeros(gbuf.y.shape, dtype=torch.float32,
                          device=gbuf.y.device)
    for li in range(lights.shape[1]):
        light = lights[:, li].contiguous()
        dot, *rays = geometry_stage(renderer, gbuf, light)
        lit = shadow_stage(renderer, dscene, bins_ent, counts, players, gbuf,
                           *rays, rows=rows)
        diffuse = shade.add_light(diffuse, shade.factor_from_dot(dot, lit,
                                                                 cfg), cfg)
    return shade.multi_light_factor(diffuse, cfg)


@tracing.spanned("batch.directional")
def directional_stage(renderer, dscene, bins_ent, counts, players, gbuf,
                      directions):
    """The Lambert dot against each frame's constant direction and the
    directional shadow march (kernel 2's directional mode, step cap
    ``shadow_dir.grid_max_steps``).  ``directions``: (F, 3) toward the
    light.  Returns ``(dot, lit)``, each (F, H, W)."""
    cfg = renderer.config
    F = directions.shape[0]
    tl, inv, K = shadow_dir.direction_constants(directions, cfg)
    dot = shade.lambert_dot(gbuf.normal,
                            tuple(tl[:, a].view(F, 1, 1) for a in range(3)))
    lit = shadow_cuda.trace_light_directional(
        dscene.pos, dscene.ext, bins_ent, counts, gbuf.y, gbuf.z,
        gbuf.entity_index, inv, K, players, cfg,
        shadow_dir.grid_max_steps(cfg))
    return dot, lit


@tracing.spanned("batch.shade")
def shade_stage(renderer, dscene, gbuf, factor, rows=None):
    """The frames of a brightness factor (F, H, W): ``Color * factor`` per
    channel with C truncation (``style="reference"``) or the palette colour
    the ordered dither picks (``style="dithered"``, at the view rows of
    the window ``rows``).  Returns (F, H, W, 3) uint8."""
    if renderer.style == "dithered":
        return dither.shade_dithered(gbuf.color, factor,
                                     dscene.palette[:, :3],
                                     row0=trace.row_window(renderer.config,
                                                           rows)[0])
    return shade.shade_u8(gbuf.color, factor)


@tracing.spanned("batch")
def render_states_batched(renderer, static_bins, dscene, players, lights,
                          directional: bool = False,
                          upto: str | None = None) -> torch.Tensor:
    """Render F frames, one per (player, light) row.

    ``renderer``: a ``DeferredRenderer`` configured for the scene.
    ``static_bins``: a ``StaticBins`` cache with ``n_dynamic=1``, or None
    for a full rebuild per frame.  players: (F, 3) int32 on the scene's
    device.  lights: (F, 3) int32, one point light per frame; (F, L, 3)
    int32 for additive multi-light frames; or, with ``directional=True``,
    (F, 3) float32 directions toward the light.  Returns (F, H, W, 3)
    uint8.

    ``upto`` raises ``NotImplementedError``; directional with (F, L, 3)
    lights raises ``ValueError``.
    """
    check_supported(lights, directional, upto)
    if not winner_inputs(renderer, lights, directional):
        # gbuffer_and_frames' body: one batch span a request.
        return gbuffer_and_frames.__wrapped__(renderer, static_bins, dscene,
                                              players, lights,
                                              directional)[1]
    bins_ent, counts = bin_stage(renderer, static_bins, dscene, players)
    winners = winner_stage(renderer, dscene, bins_ent, counts, players)
    return shade_point_stage(renderer, dscene, bins_ent, counts, players,
                             winners, lights)


def winner_inputs(renderer, lights, directional: bool) -> bool:
    """Whether a batch takes the main path, kernel 2's winner-input point
    mode: (F, 3) point lights in ``style="reference"`` without the fused
    opt-in (module docstring)."""
    return (lights.dim() == 2 and not directional
            and renderer.style == "reference"
            and not renderer.fuse_trace_shadow)


@tracing.spanned("batch")
def gbuffer_and_frames(renderer, static_bins, dscene, players, lights,
                       directional: bool = False, rows=None):
    """The body of :func:`render_states_batched` (which checks the request
    first): ``(gbuf, frames)``, the frames' G-buffer (``trace.GBufferArrays``
    batched over F) beside the (F, H, W, 3) uint8 frames.  With
    ``rows=(row0, n_rows)``, whole bin rows (``trace.row_window``), both
    hold that window's rows only, on the two-kernel path."""
    cfg = renderer.config
    if rows is not None and directional:
        raise ValueError("a row window takes point lights, not directional "
                         "ones")
    bins_ent, counts = bin_stage(renderer, static_bins, dscene, players)
    if (renderer.fuse_trace_shadow and lights.dim() == 2 and not directional
            and rows is None):
        gbuf, _, lit = fused_stage(renderer, dscene, bins_ent, counts,
                                   players, lights)
        dot = geometry_stage(renderer, gbuf, lights)[0]
        factor = shade.factor_from_dot(dot, lit, cfg)
        return gbuf, shade_stage(renderer, dscene, gbuf, factor)
    gbuf = trace_stage(renderer, dscene, bins_ent, counts, players, rows)
    if directional:
        dot, lit = directional_stage(renderer, dscene, bins_ent, counts,
                                     players, gbuf, lights)
        factor = shade.factor_from_dot(dot, lit, cfg)
    elif lights.dim() == 3:
        factor = multi_light_stage(renderer, dscene, bins_ent, counts,
                                   players, gbuf, lights, rows)
    else:
        dot, *rays = geometry_stage(renderer, gbuf, lights)
        lit = shadow_stage(renderer, dscene, bins_ent, counts, players,
                           gbuf, *rays, rows=rows)
        factor = shade.factor_from_dot(dot, lit, cfg)
    return gbuf, shade_stage(renderer, dscene, gbuf, factor, rows)
