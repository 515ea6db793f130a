"""The demo artifacts, rendered on the card: an animated GIF of the graybox
world under a sweeping light, and its first frame as a PNG.

    python -m pixel_art_raytracer_tpu_torch.make_demo OUT_DIR [n_frames=32]

The counterpart of ``tools/make_demo.py``, which renders them with the JAX
package into ``docs/``.  It renders the graybox world's light sweep of
radius 120 around the default light (``n_frames`` states, the player at
home) through ``AnimationRenderer.render_states`` on a ``StaticBins``
cache, and writes ``OUT_DIR/graybox_sweep.gif`` (5 cs a frame, the native
encoder where it builds) and ``OUT_DIR/graybox_frame.png`` (frame 0).
The frames are the C++ oracle's, so at 32 frames both files are
byte-equal to ``docs/graybox_sweep.gif`` and ``docs/graybox_frame.png``.
It never writes into ``docs/``, whose files are the JAX package's.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .device import resolve
from .models.animation import AnimationRenderer
from .models.deferred import DeferredRenderer, DeviceScene
from .ops.static_bins import StaticBins
from .scene import Scene, default_light, graybox_world
from .utils.gif import write_gif
from .utils.png import write_png

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"
RADIUS = 120
FRAMES = 32
DELAY_CS = 5


def render_sweep(scene: Scene, config: RenderConfig, n_frames: int,
                 device) -> np.ndarray:
    """The (n_frames, H, W, 3) uint8 frames of the light sweep of radius
    120 around the default light, rendered on ``device``."""
    r = DeferredRenderer(config).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, config, r.spans,
                       device=device)
    anim = AnimationRenderer(r, config, static_bins=cache)
    ds = DeviceScene.from_scene(scene, config, device=device)
    light = default_light(config)
    players, lights = anim.light_sweep_states(
        n_frames, scene.pos[0], center=(light.x, light.y, light.z),
        radius=RADIUS, device=device)
    return anim.render_states(ds, players, lights).cpu().numpy()


def out_path(out_dir) -> pathlib.Path:
    """``out_dir`` as a path; raises ``ValueError`` for the repo's
    ``docs/``."""
    out = pathlib.Path(out_dir)
    if out.resolve() == DOCS:
        raise ValueError(f"{DOCS} holds the JAX package's artifacts: "
                         f"write the port's elsewhere")
    return out


def write_demo(out_dir, frames: np.ndarray) -> str:
    """Write ``graybox_sweep.gif`` and ``graybox_frame.png`` (frame 0) of
    ``frames`` into ``out_dir`` (not ``docs/``); returns the GIF encoder
    that ran."""
    out = out_path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    encoder = write_gif(out / "graybox_sweep.gif", frames, delay_cs=DELAY_CS)
    write_png(out / "graybox_frame.png", frames[0])
    return encoder


def main(out_dir, n_frames: int = FRAMES, device=None) -> str:
    """Render the graybox sweep on ``device`` (default: the card) and
    write both files into ``out_dir``; returns the GIF encoder that ran."""
    dev = resolve(device)
    out_path(out_dir)
    config = DEFAULT_CONFIG
    frames = render_sweep(graybox_world(config), config, n_frames, dev)
    encoder = write_demo(out_dir, frames)
    print(f"wrote {out_dir}/graybox_sweep.gif ({encoder} encoder, "
          f"{n_frames} frames) and graybox_frame.png")
    return encoder


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", help="where to write (never docs/)")
    parser.add_argument("n_frames", nargs="?", type=int, default=FRAMES)
    args = parser.parse_args()
    main(args.out_dir, args.n_frames)
