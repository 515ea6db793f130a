"""Brute-force renderer: every ray against every entity, no acceleration.

Counterpart of ``pixel_art_raytracer_tpu/models/brute.py``.  The quirk-free
model family: the deferred renderer's ray, depth and shading math without
the spatial hash, so there is no wrap-at-capacity overwrite, no
insertion-order sensitivity and no early-exit culling.  It is BASELINE
config 1's small-scene renderer and a semantic cross-check: on scenes where
no bin overflows and the early exit never fires, it agrees with the
deferred path exactly.

Winner selection: the reference's sequential strictly-greater compare keeps
the first entity in index order that attains the maximal depth key.  The
JAX package runs that compare one entity at a time; here each chunk of C
entities is one set of (C, H, W) tensor ops: the chunk's largest key at
each pixel (non-hits at ``INT32_MIN``), the first entity of the chunk that
attains it, merged into the running best only where it is strictly
greater.  That keeps the same winners, across chunk boundaries and on the
padded last chunk too.  These are torch ops (the JAX module holds no
kernel), the same code on the CPU and the card; with ``shadow`` the shadow
march runs ``csrc/shadow.cu`` on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops import binning, shade
from ..ops.cstyle import c_max, c_min, l1_normalize
from ..ops.trace import INT32_MIN, GBufferArrays, _texel, materialize_gbuffer
from . import batched
from .deferred import DeviceScene

# Static per-entity bin spans of the shadowed render's tables, as the JAX
# package fixes them (models/brute.py:104-105 there).
SHADOW_SPANS = (2, 3, 2)


class BruteForceRenderer:
    """All-pixels x all-entities oblique hit test + depth argmax.

    Renders on the device of the scene it is given.
    """

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 entity_chunk: int = 512, shadow: bool = False):
        self.config = config
        self.entity_chunk = entity_chunk
        self.shadow = shadow

    def winners(self, dscene: DeviceScene) -> torch.Tensor:
        """Per-pixel winner entity (H, W) int32, -1 for background."""
        cfg = self.config
        H, W = cfg.view_height, cfg.view_width
        dev = dscene.device
        N = dscene.pos.shape[0]
        C = min(self.entity_chunk, N)
        n_chunks = -(-N // C)
        pad = n_chunks * C - N
        pos = F.pad(dscene.pos, (0, 0, 0, pad))
        ext = F.pad(dscene.ext, (0, 0, 0, pad))
        sid = F.pad(dscene.sprite_id, (0, pad))

        i = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
        j = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]
        world_j = H - j
        depth_flat = dscene.atlas_depth.reshape(-1)
        slot = torch.arange(C, dtype=torch.int32, device=dev)[:, None, None]

        best = torch.full((H, W), INT32_MIN, dtype=torch.int32, device=dev)
        winner = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        for c in range(n_chunks):
            sl = c * C
            apx, apy, apz = pos[sl:sl + C].view(C, 1, 1, 3).unbind(-1)
            aex, aey, aez = ext[sl:sl + C].view(C, 1, 1, 3).unbind(-1)
            hit = ((sl + slot < N)
                   & (i >= apx) & (i < apx + aex)
                   & (world_j > apy + apz)
                   & (world_j <= apy + aey + apz + aez))
            row = apy + aey + apz + aez - world_j
            texel = _texel(sid[sl:sl + C].view(C, 1, 1), row, i - apx, cfg)
            depth = apy - apz + (aey - row).clamp(max=0) - depth_flat[texel]
            key = torch.where(hit, depth, INT32_MIN)
            chunk_best = key.amax(dim=0)
            first = torch.where(key == chunk_best, slot, C).amin(dim=0)
            improve = chunk_best > best
            best = torch.where(improve, chunk_best, best)
            winner = torch.where(improve, sl + first, winner)
        return winner

    def trace(self, dscene: DeviceScene) -> GBufferArrays:
        """The G-buffer of :meth:`winners`, fields shaped (H, W, ...)."""
        gbuf = materialize_gbuffer(
            self.winners(dscene)[None], dscene.pos, dscene.ext,
            dscene.sprite_id, dscene.atlas_color, dscene.atlas_depth,
            dscene.atlas_normal, dscene.palette, dscene.pos[:1], self.config)
        return GBufferArrays(*(t[0] for t in gbuf))

    def render_with_gbuffer(self, dscene: DeviceScene, light):
        """Trace + shade: ``(gbuf, frame)``, frame (H, W, 3) uint8.

        Without ``shadow``, lighting is Lambert + ambient with no
        occlusion march (config-1 semantics: no shadows); with it, the
        bins of every entity (spans ``SHADOW_SPANS``), the batched path's
        geometry and shadow stages at F = 1, and the reference's u8
        scale."""
        gbuf = self.trace(dscene)
        light = torch.as_tensor(light, dtype=torch.int32,
                                device=dscene.device)
        if not self.shadow:
            return gbuf, self._shade_unshadowed(gbuf, light)
        bins_ent, counts = binning.build_bins(dscene.pos, dscene.ext,
                                              self.config, SHADOW_SPANS)
        gbuf1 = GBufferArrays(*(t[None] for t in gbuf))
        lights = light[None]
        dot, *rays = batched.geometry_stage(self, gbuf1, lights)
        lit = batched.shadow_stage(self, dscene, bins_ent[None],
                                   counts[None], dscene.pos[:1], gbuf1,
                                   *rays)
        factor = shade.factor_from_dot(dot, lit, self.config)
        return gbuf, shade.shade_u8(gbuf.color, factor[0])

    def _shade_unshadowed(self, gbuf: GBufferArrays,
                          light: torch.Tensor) -> torch.Tensor:
        """min(1, max(0, n . tl) + ambient) times the colour, tl the
        L1-normalised direction from the surface point to the light."""
        cfg = self.config
        f32 = torch.float32
        wx = torch.arange(cfg.view_width, dtype=f32,
                          device=light.device)[None, :]
        lx, ly, lz = light.to(f32).unbind()
        tl = l1_normalize(lx - wx, ly - gbuf.y.to(f32), lz - gbuf.z.to(f32))
        dot = shade.lambert_dot(gbuf.normal, tl)
        brightness = c_min(torch.ones_like(dot),
                           c_max(torch.zeros_like(dot), dot) + cfg.ambient)
        return shade.shade_u8(gbuf.color, brightness)

    def render(self, dscene: DeviceScene, light) -> torch.Tensor:
        return self.render_with_gbuffer(dscene, light)[1]
