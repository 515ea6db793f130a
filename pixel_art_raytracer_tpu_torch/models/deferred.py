"""The deferred renderer: rebin → primary trace → shadowed shade.

Counterpart of ``pixel_art_raytracer_tpu/models/deferred.py``.  A single
frame is the batched path (models/batched.py) at F = 1 with a full rebin.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve
from ..ops import binning
from ..scene import Light, Scene

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


class DeferredRenderer:
    """Full-frame renderer with reference-parity semantics.

    Usage:
        r = DeferredRenderer(config).configure_for(scene)
        dscene = DeviceScene.from_scene(scene, config)  # on the card
        frame = r.render(dscene, light_xyz)          # (H, W, 3) uint8
    """

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 style: str = "reference"):
        self.config = config
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

    def render(self, dscene: DeviceScene, light) -> torch.Tensor:
        """One frame under point light ``light`` (x, y, z) with the player
        where ``dscene.pos[0]`` puts it.  Returns (H, W, 3) uint8."""
        from .batched import render_states_batched

        light = torch.as_tensor(light, dtype=torch.int32,
                                device=dscene.device)
        return render_states_batched(self, None, dscene, dscene.pos[:1],
                                     light[None])[0]

    def render_numpy(self, scene: Scene, light: Light, *,
                     device=None) -> np.ndarray:
        dscene = DeviceScene.from_scene(scene, self.config, device=device)
        return self.render(dscene, light.as_array()).cpu().numpy()
