"""Primary visibility and shadow occlusion in one pass: the plain version of
kernel 3.

Counterpart of ``pixel_art_raytracer_tpu/ops/fused_pallas.py``, whose TPU
kernel runs the trace kernel and then the shadow kernel on each tile in one
launch.  :func:`trace_shadow` is the composition that ``csrc/fused.cu``
computes, pixel for pixel:

  1. :func:`trace.trace_winner` — the winner and best depth of each pixel;
  2. :func:`trace.decode_winner` — the winner's surface point (y, z,
     entity), background giving y = z = entity = 0 (quirk Q6);
  3. :func:`shade.light_geometry` — the shadow ray's start bin, origin and
     inverse direction, and the light's bin;
  4. :func:`shadow.trace_light_dynamic` — the 7-phase DDA march.

It is what ``ops/fused_cuda.trace_shadow`` runs for CPU tensors.
"""

from __future__ import annotations

from ..config import RenderConfig
from . import shade, shadow, trace


def trace_shadow(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                 players, lights, config: RenderConfig,
                 work: dict | None = None):
    """Per-pixel ``(best, winner, lit)``, each (F, H, W).

    Args:
      pos, ext: (N, 3) int32; sprite_id: (N,) int32.
      atlas_depth: (S, SH, SW) int32.
      bins_ent: (F, V, C) int32 (-1 empty); counts: (F, V) int32.
      players: (F, 3) int32 — entity 0's position per frame.
      lights: (F, 3) int32 — one point light per frame.
      work: when given, receives the walk's ``candidate_tests`` and
        ``candidate_hits`` and the march's ``slab_tests`` (see the two
        functions).

    Returns best depth (int32, INT32_MIN for background), winner entity
    (int32, -1 for background) and the lit mask (bool).
    """
    best, winner = trace.trace_winner(pos, ext, sprite_id, atlas_depth,
                                      bins_ent, counts, players, config,
                                      work=work)
    y, z, ent, _ = trace.decode_winner(winner, pos, ext, sprite_id,
                                       atlas_depth, players, config)
    surface = trace.GBufferArrays(normal=None, color=None, y=y, z=z,
                                  entity_index=ent)
    _, inv, origin, rb, lb = shade.light_geometry(surface, lights, config)
    lit = shadow.trace_light_dynamic(pos, ext, bins_ent, counts, rb, lb, ent,
                                     origin, inv, players, config, work=work)
    return best, winner, lit
