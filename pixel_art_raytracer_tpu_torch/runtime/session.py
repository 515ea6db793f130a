"""Interactive session runtime: the reference event loop, headless.

Counterpart of ``pixel_art_raytracer_tpu/runtime/session.py``.  The
reference runs an SDL window: poll events -> mutate player/light -> render
-> blit, printing the hovered pixel's G-buffer fields and drawing a red
cursor-to-light debug line (alternative.cpp:628-817).  This runtime keeps
those capabilities without a display: events come from a script (or are fed
interactively via ``feed``), each frame renders on the scene's device and is
fetched to the host, where the mouse inspector and the overlay line work on
the host copy, and frames accumulate in memory or stream to GIF.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..models.animation import WorldState, apply_keys, scene_with_player
from ..models.deferred import DeferredRenderer, DeviceScene
from ..ops.cstyle import normal_to_debug_color
from ..ops.overlay import draw_line_host
from ..scene import Light, Scene
from ..utils.gif import write_gif
from . import tracing


@dataclasses.dataclass
class FrameRecord:
    image: np.ndarray                    # (H, W, 3) uint8, with overlay
    mouse_pixel_y: int
    mouse_pixel_z: int


def host_state(player_pos, light) -> WorldState:
    """The world state as (3,) int32 CPU tensors: the reference's integer
    fields, which key events write on the host; each frame's render copies
    them to the scene's device."""
    return WorldState(
        player_pos=torch.tensor(np.asarray(player_pos), dtype=torch.int32),
        light=torch.tensor(np.asarray(light), dtype=torch.int32))


class Session:
    """Headless interactive loop over a scene, rendered on ``device``
    (default: the card).

    Example::

        s = Session(graybox_world())
        s.feed(["left", "left"])    # one frame with two key events
        s.feed([])                  # one idle frame
        s.save_gif("out.gif")
    """

    def __init__(self, scene: Scene, light: Light | None = None,
                 config: RenderConfig = DEFAULT_CONFIG,
                 renderer: DeferredRenderer | None = None, *, device=None):
        self.config = config
        self.renderer = renderer or DeferredRenderer(config)
        self.renderer.spans = self.renderer.spans_for(scene)
        self.dscene = DeviceScene.from_scene(scene, config, device=device)
        if light is None:
            light = Light(config.view_width, config.view_height // 2,
                          config.view_length // 4)
        self.state = host_state(scene.pos[0], light.as_array())
        self.mouse = (0, 0)
        self.frames: list[FrameRecord] = []
        self.running = True

    # -- event handling (alternative.cpp:630-687) --------------------------

    def feed(self, keys: list[str], mouse: tuple[int, int] | None = None
             ) -> FrameRecord:
        """Apply one frame's events, render, record, return the frame
        (one ``frame`` span of ``runtime/tracing.py``)."""
        with tracing.span("frame"):
            if "escape" in keys:
                self.running = False
                keys = [k for k in keys if k != "escape"]
            self.state = apply_keys(self.state, keys)
            if mouse is not None:
                self.mouse = mouse
            return self._render_frame()

    def run_script(self, script: list[list[str]]) -> list[FrameRecord]:
        for keys in script:
            if not self.running:
                break
            self.feed(keys)
        return self.frames

    # -- rendering ---------------------------------------------------------

    def _render_frame(self) -> FrameRecord:
        scene_f = scene_with_player(self.dscene, self.state.player_pos)
        gbuf, frame = self.renderer.render_with_gbuffer(scene_f,
                                                        self.state.light)
        with tracing.span("sync.fetch"):
            host = frame.cpu()
        cfg = self.config

        # Mouse-pixel inspector (alternative.cpp:380-382, 698-700): the
        # readout clamps the cursor into the frame...
        mx = min(max(self.mouse[0], 0), cfg.view_width - 1)
        my = min(max(self.mouse[1], 0), cfg.view_height - 1)
        with tracing.span("sync.readback"):
            mp_y = int(gbuf.y[my, mx])
            mp_z = int(gbuf.z[my, mx])

        # ...while the debug overlay's red line from the hovered pixel to
        # the light starts at the unclamped cursor x (alternative.cpp:
        # 762-772; the JAX session does the same).
        with tracing.span("frame.overlay"):
            image = host.numpy().copy()
            lx, ly, lz = self.state.light.tolist()
            draw_line_host(image, self.mouse[0],
                           cfg.view_height - (mp_y + mp_z),
                           lx, cfg.view_height - (ly + lz), (255, 0, 0))

        with tracing.span("frame.keep"):
            rec = FrameRecord(image=image, mouse_pixel_y=mp_y,
                              mouse_pixel_z=mp_z)
            self.frames.append(rec)
        return rec

    # -- debug / observability --------------------------------------------

    def debug_report(self) -> str:
        """Debug-build state dump (alternative.cpp:790-813 equivalent):
        player AABB corners plus the bin-occupancy slice through the
        player's bin column."""
        cfg = self.config
        player = self.state.player_pos.numpy()
        ext = self.dscene.ext[0].cpu().numpy()
        scene_f = scene_with_player(self.dscene, self.state.player_pos)
        _, counts = self.renderer.build_bins(scene_f)
        counts = counts.cpu().numpy().reshape(cfg.hash_width, cfg.hash_height,
                                              cfg.hash_length)
        bx = min(max(int(player[0]) // cfg.bin_size, 0), cfg.hash_width - 1)
        lines = [
            f"<{player[0]}, {player[1]}, {player[2]}>",
            f"<{player[0] + ext[0]}, {player[1] + ext[1]}, "
            f"{player[2] + ext[2]}>",
        ]
        for j in range(cfg.hash_height):
            lines.append(" ".join(str(counts[bx, j, k])
                                  for k in range(cfg.hash_length)))
        return "\n".join(lines)

    def normal_view(self) -> np.ndarray:
        """Debug normal visualisation using the reference's Vector->Color
        cast (sprites.hpp:37-51), on the host copy of the normals."""
        scene_f = scene_with_player(self.dscene, self.state.player_pos)
        gbuf, _ = self.renderer.render_with_gbuffer(scene_f, self.state.light)
        n = gbuf.normal.cpu().numpy()
        with np.errstate(invalid="ignore"):
            r, g, b = normal_to_debug_color(n[..., 0], n[..., 1], n[..., 2])
        return np.stack([r, g, b], axis=-1)

    # -- writeback ---------------------------------------------------------

    def save_gif(self, path, delay_cs: int = 4) -> str:
        """Write the recorded frames as a GIF; returns the encoder that
        ran ('native' or 'python')."""
        if not self.frames:
            raise ValueError("no frames rendered")
        stack = np.stack([f.image for f in self.frames])
        return write_gif(path, stack, delay_cs=delay_cs)
