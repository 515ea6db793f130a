"""What the benchmark hands the program: its configuration and scene,
built from the benchmark's own arrays.  The entries and this module are
the only parts of the benchmark that import the program."""

from __future__ import annotations

from pixel_art_raytracer_tpu_torch.assets import SpriteAtlas
from pixel_art_raytracer_tpu_torch.config import RenderConfig
from pixel_art_raytracer_tpu_torch.scene import Scene

CONFIG_KEYS = ("view_width", "view_height", "view_length", "bin_size",
               "bin_capacity", "sprite_width", "sprite_height", "ambient",
               "early_exit")


def render_config(config: dict) -> RenderConfig:
    """The program's base configuration of a configuration file."""
    return RenderConfig(
        **{k: config[k] for k in CONFIG_KEYS},
        background=tuple(config["background"]),
        palette=tuple(tuple(c) for c in config["palette"]))


def scene(arrays: dict) -> Scene:
    """The program's scene of the benchmark's scene arrays."""
    return Scene(pos=arrays["pos"], ext=arrays["ext"],
                 sprite_id=arrays["sprite_id"],
                 atlas=SpriteAtlas(color=arrays["atlas_color"],
                                   depth=arrays["atlas_depth"],
                                   normal=arrays["atlas_normal"]))
