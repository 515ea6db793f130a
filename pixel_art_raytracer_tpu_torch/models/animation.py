"""Animation runtime: world state, key events and batched frame rendering.

Counterpart of ``pixel_art_raytracer_tpu/models/animation.py``.  The
reference's interactivity is integer field writes driven by key events,
picked up by the next frame's rebin and trace (alternative.cpp:628-687).
Here a batch of per-frame states renders through the batched path
(models/batched.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve
from ..runtime import tracing
from .batched import render_states_batched
from .deferred import DeferredRenderer, DeviceScene

# Key step size (alternative.cpp:643-678): every binding moves by 5 units.
KEY_STEP = 5

# Key -> (target, axis, sign): arrows/page move the player box (entity 0),
# a/k/j/u/h/o move the light.
KEY_BINDINGS = {
    "left": ("player", 0, -1),
    "right": ("player", 0, +1),
    "up": ("player", 2, +1),
    "down": ("player", 2, -1),
    "pagedown": ("player", 1, -1),
    "pageup": ("player", 1, +1),
    "a": ("light", 2, -1),
    "k": ("light", 2, +1),
    "j": ("light", 1, -1),
    "u": ("light", 1, +1),
    "h": ("light", 0, -1),
    "o": ("light", 0, +1),
}


class WorldState(NamedTuple):
    """Per-frame mutable world state (the rest of the scene is static)."""

    player_pos: torch.Tensor  # (3,) int32 — entity 0 position
    light: torch.Tensor       # (3,) int32


def scene_with_player(dscene: DeviceScene, player_pos) -> DeviceScene:
    """A new scene with entity 0 (the reference's player) at
    ``player_pos`` (3,): ``pos`` is cloned with row 0 set, so the caller's
    tensor is never written."""
    pos = dscene.pos.clone()
    with tracing.span("sync.upload"):
        pos[0] = torch.as_tensor(player_pos, dtype=torch.int32).to(pos.device)
    return dataclasses.replace(dscene, pos=pos)


def apply_keys(state: WorldState, keys: list[str]) -> WorldState:
    """Host-side event application, one frame's worth of key presses."""
    player = state.player_pos.clone()
    light = state.light.clone()
    for key in keys:
        target, axis, sign = KEY_BINDINGS[key]
        moved = player if target == "player" else light
        moved[axis] += sign * KEY_STEP
    return WorldState(player_pos=player, light=light)


class AnimationRenderer:
    """Renders batches of (player position, light) states."""

    def __init__(self, renderer: DeferredRenderer | None = None,
                 config: RenderConfig = DEFAULT_CONFIG, static_bins=None):
        """``static_bins``: an ``ops.static_bins.StaticBins`` cache of the
        scene's static tail (``n_dynamic=1``); when given, per-frame binning
        merges only the player (bit-identical tables).  Without it every
        frame rebuilds its tables from all entities."""
        self.renderer = renderer or DeferredRenderer(config)
        self.config = self.renderer.config
        self.static_bins = static_bins

    def render_states(self, dscene: DeviceScene, player_pos: torch.Tensor,
                      lights: torch.Tensor,
                      directional: bool = False) -> torch.Tensor:
        """Render one frame per state row.

        player_pos: (F, 3) int32 on the scene's device.  lights: (F, 3)
        int32, one point light per frame, or (F, L, 3) int32 for additive
        multi-light frames (the shadow march runs once per light).  With
        ``directional=True``, lights is (F, 3) float32 directions toward
        the light (the JAX package's ``shade_directional``).  The
        renderer's style applies to every mode.  Returns (F, H, W, 3)
        uint8; see ``models/batched.py``.
        """
        return render_states_batched(self.renderer, self.static_bins, dscene,
                                     player_pos, lights,
                                     directional=directional)

    def light_sweep_states(self, n_frames: int, player_pos, center=None,
                           radius: int = 140, *, device=None):
        """A circular light sweep around ``center`` with the player fixed.

        Returns ``(players, lights)``, (n_frames, 3) int32 each, on
        ``device`` (default: the card); the same states as the JAX
        package's sweep.
        """
        cfg = self.config
        if center is None:
            center = (cfg.view_width // 2, cfg.view_height // 2,
                      cfg.view_length // 4)
        t = np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False)
        lx = (center[0] + radius * np.cos(t)).astype(np.int32)
        ly = np.full(n_frames, center[1], np.int32)
        lz = (center[2] + (radius // 2) * np.sin(t)).astype(np.int32)
        lights = np.stack([lx, ly, lz], axis=1)
        players = np.broadcast_to(np.asarray(player_pos, np.int32),
                                  (n_frames, 3))
        dev = resolve(device)
        return (torch.as_tensor(players.copy(), device=dev),
                torch.as_tensor(lights, device=dev))

    def render_long(self, dscene: DeviceScene, player_pos, lights,
                    checkpoint_dir, chunk_size: int = 16) -> np.ndarray:
        """Long animation render with chunked checkpoint/resume.

        Renders ``player_pos``/``lights`` ((F, 3) int32 each, one point
        light per frame) in batches of ``chunk_size`` frames, the last one
        padded with the last state; each finished chunk persists to
        ``checkpoint_dir`` and a restart skips the chunks on disk
        (``utils/checkpoint.py``).  Returns all (F, H, W, 3) uint8 frames
        as numpy.
        """
        from ..utils.checkpoint import render_with_checkpoints

        dev = dscene.device
        players = torch.as_tensor(player_pos, dtype=torch.int32, device=dev)
        lights = torch.as_tensor(lights, dtype=torch.int32, device=dev)
        F = players.shape[0]
        pad = (-F) % chunk_size
        players_p = torch.cat([players, players[-1:].expand(pad, 3)])
        lights_p = torch.cat([lights, lights[-1:].expand(pad, 3)])

        def render_chunk(start, count):
            frames = self.render_states(
                dscene, players_p[start:start + chunk_size],
                lights_p[start:start + chunk_size])
            return frames[:count].cpu().numpy()

        return render_with_checkpoints(render_chunk, F, checkpoint_dir,
                                       chunk_size)

    def render_script(self, dscene: DeviceScene, initial: WorldState,
                      script: list[list[str]]):
        """Apply a per-frame key-event script and render each resulting
        frame, as the reference's event loop does: events mutate the state,
        the next frame renders the mutated world.  Returns ``(frames,
        final_state)``, frames (len(script), H, W, 3) uint8 on the scene's
        device."""
        players, lights = [], []
        state = initial
        for keys in script:
            state = apply_keys(state, keys)
            players.append(state.player_pos.cpu())
            lights.append(state.light.cpu())
        dev = dscene.device
        frames = self.render_states(dscene, torch.stack(players).to(dev),
                                    torch.stack(lights).to(dev))
        return frames, state
