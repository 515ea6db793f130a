"""Supersampled rendering (BASELINE config 5).

Counterpart of ``pixel_art_raytracer_tpu/models/supersample.py``.  The
renderer's geometry is integer world units == pixels, so supersampling
scales the *world* by an integer factor s (positions, extents, bin size,
sprite maps, light), renders s-times larger frames through the batched
path, and box-filters them down to the base size: on the card one launch
of ``csrc/filter.cu`` a call (``ops/filter_cuda.py``), on the CPU the
plain chain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..assets import SpriteAtlas
from ..config import RenderConfig
from ..ops import filter_cuda
from ..runtime import tracing
from ..scene import Light, Scene
from . import batched
from .deferred import DeferredRenderer, DeviceScene


def scaled_config(config: RenderConfig, s: int) -> RenderConfig:
    """``config`` with the view, the bin and the sprite maps s times
    larger; the hash grid keeps its shape."""
    return dataclasses.replace(
        config,
        view_width=config.view_width * s,
        view_height=config.view_height * s,
        view_length=config.view_length * s,
        bin_size=config.bin_size * s,
        sprite_width=config.sprite_width * s,
        sprite_height=config.sprite_height * s,
    )


def ramp_depth_params(depth: np.ndarray):
    """Per-sprite ``(d0, slope)`` with ``depth[r, c] == max(0, d0 -
    slope * r)``, int32 arrays of shape (S,), or None when some sprite's
    depth map is not such a ramp.

    The port's own copy of the JAX package's
    ``ops/trace_pallas.ramp_depth_params``.
    """
    s, h, _ = depth.shape
    d0 = depth[:, 0, 0].astype(np.int64)
    if h > 1:
        slope = (depth[:, 0, 0] - depth[:, 1, 0]).astype(np.int64)
    else:
        slope = np.zeros(s, np.int64)
    rows = np.arange(h, dtype=np.int64)[None, :, None]
    expect = np.maximum(0, d0[:, None, None] - slope[:, None, None] * rows)
    if not bool((expect == depth.astype(np.int64)).all()):
        return None
    return d0.astype(np.int32), slope.astype(np.int32)


def scale_atlas(atlas: SpriteAtlas, s: int) -> SpriteAtlas:
    """The sprite texel maps s times larger.

    Colour and normal repeat (nearest neighbour: crisp pixel-art edges).
    Depth values are world offsets, so they scale by s: ramp sprites get
    the finer ramp ``max(0, (s * d0 + s - 1) - slope * row)`` and
    zero-slope sprites keep ``s * d0``; any other atlas repeats its depth
    and multiplies it by s.
    """
    color = np.repeat(np.repeat(atlas.color, s, axis=1), s, axis=2)
    normal = np.repeat(np.repeat(atlas.normal, s, axis=1), s, axis=2)
    params = ramp_depth_params(np.asarray(atlas.depth))
    S, H, W = atlas.depth.shape
    if params is not None:
        d0, slope = params
        rows = np.arange(H * s, dtype=np.int64)[None, :, None]
        D0 = (s * d0.astype(np.int64) + s - 1)[:, None, None]
        SL = slope.astype(np.int64)[:, None, None]
        depth = np.maximum(0, D0 - SL * rows).astype(np.int32)
        depth = np.broadcast_to(depth, (S, H * s, W * s)).copy()
        depth[slope == 0] = (s * d0[slope == 0])[:, None, None]
    else:
        depth = np.repeat(np.repeat(atlas.depth, s, axis=1), s, axis=2) * s
    return SpriteAtlas(color=color, depth=depth, normal=normal)


def scale_scene(scene: Scene, s: int) -> Scene:
    """World coordinates and the atlas scaled by s."""
    return dataclasses.replace(scene, pos=scene.pos * s, ext=scene.ext * s,
                               atlas=scale_atlas(scene.atlas, s))


def box_filter(frames: torch.Tensor, s: int) -> torch.Tensor:
    """The mean of each s x s block of (H * s, W * s, 3) or (F, H * s,
    W * s, 3) uint8 frames, truncated to uint8: (H, W, 3) or (F, H, W, 3).

    CUDA tensors take one launch of the kernel (``ops/filter_cuda.py``),
    with no host wait; CPU tensors take :func:`plain_box_filter`.  Both
    give the same bytes.
    """
    if frames.is_cuda:
        return filter_cuda.box_filter(frames.contiguous(), s)
    return plain_box_filter(frames, s)


def plain_box_filter(frames: torch.Tensor, s: int) -> torch.Tensor:
    """:func:`box_filter` as a chain of tensor ops, on any device.

    The float32 sum of s * s u8 values is exact, and it is divided by a
    tensor (IEEE division on the card too, where dividing by a Python
    scalar multiplies by its reciprocal), so the result is the JAX
    package's ``mean(axis=(1, 3))`` for any s; truncated, it is the
    integer sum // (s * s) that the kernel computes.
    """
    h, w = frames.shape[-3] // s, frames.shape[-2] // s
    total = frames.to(torch.float32).reshape(
        *frames.shape[:-3], h, s, w, s, 3).sum(dim=(-4, -2))
    count = torch.tensor(float(s * s), dtype=torch.float32,
                         device=frames.device)
    return (total / count).to(torch.uint8)


def filtered_states(renderer: DeferredRenderer, s: int,
                    dscene_scaled: DeviceScene, players, lights,
                    static_bins=None) -> torch.Tensor:
    """F base-size frames (F, H, W, 3) uint8, one per (player, light) row:
    ``render_states_batched`` of ``renderer`` (configured for the scene
    scaled by s) on the scaled scene, then the box filter, in one
    ``batch`` span (the filter in ``batch.filter``).

    players and lights: (F, 3) int32 on the scene's device, in traced-world
    units (base units times s), as ``AnimationRenderer.render_states``
    takes them; (F, L, 3) lights for additive multi-light frames.
    ``static_bins``: a ``StaticBins`` cache of the scaled scene with
    ``n_dynamic=1``, or None for a full rebin of every frame.
    """
    with tracing.span("batch"):
        # render_states_batched's body: one batch span a request.
        frames = batched.render_states_batched.__wrapped__(
            renderer, static_bins, dscene_scaled, players, lights)
        with tracing.span("batch.filter"):
            return box_filter(frames, s)


class SupersampledRenderer:
    """Render at s times the resolution, box-filter to the base size.

    Sprite texel addressing follows world coordinates, so the scaled render
    magnifies each texel s-fold: clean s x s edges averaged down.

    The JAX package's renderer takes ``shadow_max_steps = 16 * s``, the
    static bound of its shadow tables behind an exact guard; the port's
    shadow march has no step bound and is exact, so it takes no such
    knob.  Frames of any size render through the batched path at F = 1
    (``DeferredRenderer.render``), which is where the JAX package reroutes
    frames above 2**20 pixels.
    """

    def __init__(self, config: RenderConfig, factor: int = 2, **renderer_kw):
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self.factor = factor
        self.base_config = config
        self.config = scaled_config(config, factor)
        self.renderer = DeferredRenderer(self.config, **renderer_kw)

    def prepare(self, scene: Scene, *, device=None) -> DeviceScene:
        """The scaled scene on ``device`` (default: the card), with the
        renderer configured for it."""
        scaled = scale_scene(scene, self.factor)
        self.renderer.configure_for(scaled)
        return DeviceScene.from_scene(scaled, self.config, device=device)

    def render_states(self, dscene_scaled: DeviceScene, players, lights,
                      static_bins=None) -> torch.Tensor:
        """:func:`filtered_states` on this renderer and factor."""
        return filtered_states(self.renderer, self.factor, dscene_scaled,
                               players, lights, static_bins)

    def render(self, dscene_scaled: DeviceScene, light) -> torch.Tensor:
        """One base-size frame (H, W, 3) uint8 under point light ``light``
        (base-world x, y, z), the player where the scaled scene puts it:
        :meth:`render_states` at F = 1 with a full rebin."""
        with tracing.span("sync.upload"):
            light = torch.as_tensor(light, dtype=torch.int32,
                                    device=dscene_scaled.device)
        return self.render_states(dscene_scaled, dscene_scaled.pos[:1],
                                  light[None] * self.factor)[0]

    def render_numpy(self, scene: Scene, light, *,
                     device=None) -> np.ndarray:
        ds = self.prepare(scene, device=device)
        if isinstance(light, Light):
            light = light.as_array()
        return self.render(ds, light).cpu().numpy()
