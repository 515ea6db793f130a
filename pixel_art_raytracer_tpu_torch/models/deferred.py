"""The deferred renderer: rebin → primary trace → shadowed shade.

Counterpart of ``pixel_art_raytracer_tpu/models/deferred.py``.  A single
frame is the batched path (models/batched.py) at F = 1 with a full rebin;
its stages are public as in the JAX package (``build_bins``, ``trace``,
``shade``), and ``render_with_gbuffer`` hands back the G-buffer beside the
frame for the session, the viewer and their mouse inspector, where
``render`` takes the main path, which holds none.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve
from ..ops import binning, dither
from ..ops import shade as shade_ops
from ..ops.trace import GBufferArrays
from ..runtime import tracing
from ..scene import Light, Scene
from . import batched

STYLES = ("reference", "dithered")


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """A scene's arrays as tensors on one device.

    The atlas is stored once and entities carry sprite ids (quirk Q7).
    """

    pos: torch.Tensor           # (N, 3) int32
    ext: torch.Tensor           # (N, 3) int32
    sprite_id: torch.Tensor     # (N,) int32
    atlas_color: torch.Tensor   # (S, SH, SW) int32
    atlas_depth: torch.Tensor   # (S, SH, SW) int32
    atlas_normal: torch.Tensor  # (S, SH, SW, 3) float32
    palette: torch.Tensor       # (P, 4) uint8

    @classmethod
    def from_scene(cls, scene: Scene, config: RenderConfig = DEFAULT_CONFIG,
                   *, device=None) -> "DeviceScene":
        return cls.from_numpy(
            {"pos": scene.pos, "ext": scene.ext,
             "sprite_id": scene.sprite_id,
             "atlas_color": scene.atlas.color,
             "atlas_depth": scene.atlas.depth,
             "atlas_normal": scene.atlas.normal,
             "palette": config.palette_array},
            device=device)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], *,
                   device=None) -> "DeviceScene":
        """Tensors on ``device`` (default: the card) from numpy arrays keyed
        by field name.

        Takes the fields of the JAX package's ``DeviceScene`` (``np.asarray``
        of each); its TPU-only ``depth_d0``/``depth_slope`` are not read.
        """
        dtypes = {"atlas_normal": torch.float32, "palette": torch.uint8}
        dev = resolve(device)
        return cls(**{
            f.name: torch.tensor(np.asarray(arrays[f.name]),
                                 dtype=dtypes.get(f.name, torch.int32),
                                 device=dev)
            for f in dataclasses.fields(cls)})

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @functools.cached_property
    def palette_luma(self) -> torch.Tensor:
        """(P,) float32 ``dither.luminance`` of the palette's colours, the
        table the winner-input directional mode dithers with: computed on
        the scene's device at first use and kept."""
        return dither.luminance(self.palette[:, :3])


class DeferredRenderer:
    """Full-frame renderer with reference-parity semantics.

    Usage:
        r = DeferredRenderer(config).configure_for(scene)
        dscene = DeviceScene.from_scene(scene, config)  # on the card
        frame = r.render(dscene, light_xyz)          # (H, W, 3) uint8
        gbuf, frame = r.render_with_gbuffer(dscene, light_xyz)

    ``shadow_max_steps`` is read by ``InverseLightFitter`` only: the render
    paths march exactly, whatever it is.
    """

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 style: str = "reference", shadow_max_steps: int = 16):
        self.config = config
        # The step cap of the JAX package's statically bounded shadow march
        # (ops/shadow.py::trace_light there), which its inverse fitter's
        # soft_frame runs: a ray probes 7 * min(int(largest),
        # shadow_max_steps) phases.  The render paths march exactly and do
        # not read it.
        if shadow_max_steps is None or shadow_max_steps < 1:
            raise ValueError(f"shadow_max_steps={shadow_max_steps!r}: a cap "
                             f"of at least 1 step")
        self.shadow_max_steps = shadow_max_steps
        # Static per-entity bin-span bound until configure_for derives it;
        # (2, 3, 2) covers any scene whose extents stay within one bin (the
        # reference world is all 20-cubes).
        self.spans = (2, 3, 2)
        # 'reference' scales the palette colour by the brightness factor
        # (alternative.cpp:757-758); 'dithered' re-quantises the lit
        # luminance onto the palette with a Bayer matrix (ops/dither.py,
        # BASELINE config 4).
        if style not in STYLES:
            raise ValueError(f"style={style!r}: expected one of {STYLES}")
        self.style = style
        # Batched path: run primary visibility and the shadow march as one
        # kernel (csrc/fused.cu) instead of two, the same frames either way.
        # Off by default, as in the JAX package (models/deferred.py:239).
        self.fuse_trace_shadow = False

    def configure_for(self, scene: Scene) -> "DeferredRenderer":
        """Derive the bin-span bound from the scene's extents."""
        self.spans = self.spans_for(scene)
        return self

    def spans_for(self, scene: Scene) -> tuple[int, int, int]:
        return binning.entity_span_bound(np.asarray(scene.ext).max(axis=0),
                                         self.config)

    # -- the stages of one frame (models/batched.py at F = 1) ---------------

    def build_bins(self, dscene: DeviceScene):
        """The frame's bin tables, rebuilt from every entity:
        ``(bins_ent (V, cap), counts (V,))`` int32."""
        bins_ent, counts = batched.bin_stage(self, None, dscene,
                                             dscene.pos[:1])
        return bins_ent[0], counts[0]

    def trace(self, dscene: DeviceScene, bins_ent, counts,
              rows=None) -> GBufferArrays:
        """Primary visibility (kernel 1) into the frame's G-buffer, fields
        shaped (H, W, ...); ``rows=(row0, n_rows)``, whole bin rows, traces
        that window only, as the JAX package's ``row0``/``n_rows``."""
        gbuf = batched.trace_stage(self, dscene, bins_ent[None],
                                   counts[None], dscene.pos[:1], rows)
        return GBufferArrays(*(t[0] for t in gbuf))

    def shade(self, dscene: DeviceScene, gbuf: GBufferArrays, bins_ent,
              counts, light) -> torch.Tensor:
        """Light geometry, the shadow march (kernel 2) and the shade of a
        G-buffer from :meth:`trace` under point light ``light`` (x, y, z).
        Returns (H, W, 3) uint8."""
        lights = self._lights(dscene, light)
        gbuf = GBufferArrays(*(t[None] for t in gbuf))
        dot, *rays = batched.geometry_stage(self, gbuf, lights)
        lit = batched.shadow_stage(self, dscene, bins_ent[None],
                                   counts[None], dscene.pos[:1], gbuf, *rays)
        factor = shade_ops.factor_from_dot(dot, lit, self.config)
        return batched.shade_stage(self, dscene, gbuf, factor)[0]

    # -- whole-frame entry points --------------------------------------------

    def render_with_gbuffer(self, dscene: DeviceScene, light):
        """One frame under point light ``light`` (x, y, z) with the player
        where ``dscene.pos[0]`` puts it: ``(gbuf, frame)``, the G-buffer
        (fields (H, W, ...)) and the (H, W, 3) uint8 frame.

        The batched path at F = 1 with a full rebin: :meth:`build_bins`,
        :meth:`trace` and :meth:`shade`, or, with ``fuse_trace_shadow``,
        the fused kernel in place of the last two's kernels."""
        lights = self._lights(dscene, light)
        batched.check_supported(lights, False, None)
        gbuf, frames = batched.gbuffer_and_frames(self, None, dscene,
                                                  dscene.pos[:1], lights)
        return GBufferArrays(*(t[0] for t in gbuf)), frames[0]

    def render(self, dscene: DeviceScene, light) -> torch.Tensor:
        """The frame of :meth:`render_with_gbuffer`, (H, W, 3) uint8,
        without its G-buffer: ``render_states_batched`` at F = 1 with a
        full rebin, so a point light in the reference style takes the main
        path (``models/batched.py``), as the JAX package's ``render`` does
        for frames of 2**20 pixels and more."""
        return batched.render_states_batched(
            self, None, dscene, dscene.pos[:1],
            self._lights(dscene, light))[0]

    @staticmethod
    def _lights(dscene: DeviceScene, light) -> torch.Tensor:
        """``light`` as the (1, 3) int32 batch of one frame on the scene's
        device."""
        with tracing.span("sync.upload"):
            return torch.as_tensor(light, dtype=torch.int32,
                                   device=dscene.device)[None]

    def render_numpy(self, scene: Scene, light: Light, *,
                     device=None) -> np.ndarray:
        dscene = DeviceScene.from_scene(scene, self.config, device=device)
        return self.render(dscene, light.as_array()).cpu().numpy()
