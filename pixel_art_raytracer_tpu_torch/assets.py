"""Sprite assets: texel maps for color-palette index, depth, and normal.

The port's own copy of ``pixel_art_raytracer_tpu/assets.py``.

The reference ships exactly one sprite — a 20x40 checkerboard floor tile built
``constexpr`` (src/sprites.hpp:67-364).  It stores one 16 KB ``Sprite`` copy
per entity (162k copies, ~2.4 GiB; see SURVEY.md Q7).  Here sprites live in a
single **atlas**: arrays shaped ``(n_sprites, sprite_h, sprite_w)``, and
entities carry an atlas index instead.

The tile is generated procedurally rather than as a literal table; the
generated arrays are texel-identical to the reference tables (verified by the
C++ oracle cross-check in tests).

Layout of a sprite texel map (sprites.hpp:68-70):
  * rows 0..19  — the *top* face of the box, viewed obliquely.  Depth runs
    19 (far row, drawn highest on screen) down to 0; normal is (0, 1, 0).
  * rows 20..39 — the *front* face.  Depth 0; normal is (0, 0, -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpriteAtlas:
    """Immutable sprite atlas.

    Fields (numpy on host; converted to tensors at render time):
      color:  (S, H, W) int32  — palette indices
      depth:  (S, H, W) int32  — per-texel depth offsets
      normal: (S, H, W, 3) float32 — per-texel normals
    """

    color: np.ndarray
    depth: np.ndarray
    normal: np.ndarray

    def __post_init__(self):
        s, h, w = self.color.shape
        assert self.depth.shape == (s, h, w)
        assert self.normal.shape == (s, h, w, 3)

    @property
    def n_sprites(self) -> int:
        return self.color.shape[0]

    @property
    def sprite_height(self) -> int:
        return self.color.shape[1]

    @property
    def sprite_width(self) -> int:
        return self.color.shape[2]

    @property
    def depth_is_row_only(self) -> bool:
        """True when every sprite's depth map is constant along columns.

        The shipped tile (and any sprite skinning an axis-aligned box face-on)
        has this property; the JAX package's TPU primary kernel exploits it
        to turn the per-texel depth gather into a contiguous row slice.
        """
        return bool(np.all(self.depth == self.depth[:, :, :1]))

    def row_depth(self) -> np.ndarray:
        """(S, H) int32 depth-by-row table (valid iff depth_is_row_only)."""
        return np.ascontiguousarray(self.depth[:, :, 0])


def make_tile_floor(width: int = 20, height: int = 40) -> SpriteAtlas:
    """Build the reference's checkerboard floor tile as a 1-sprite atlas.

    Produces arrays equal to ``make_tile_floor`` (sprites.hpp:73-364):
      color (palette indices):
        top face  rows 0..19 : border 0; inner 12x12 split into four 6x6
                               quadrants: 2 | 3 over 3 | 2 (checkerboard).
        front face rows 20..37: columns 0,1 and 18,19 are 1, middle is 2.
        front face rows 38,39: all 1.
      depth: top rows r -> (19 - r); front rows -> 0.
      normal: top rows (0,1,0); front rows (0,0,-1).
    """
    if (width, height) != (20, 40):
        raise ValueError("the reference tile asset is 20x40")

    color = np.zeros((height, width), np.int32)
    # Top-face inner checkerboard (rows 4..15, cols 4..15), 6x6 quadrants.
    color[4:10, 4:10] = 2
    color[4:10, 10:16] = 3
    color[10:16, 4:10] = 3
    color[10:16, 10:16] = 2
    # Front face: dark edges, bright-gray middle, dark bottom strip.
    color[20:38, :] = 2
    color[20:38, :2] = 1
    color[20:38, 18:] = 1
    color[38:, :] = 1

    depth = np.zeros((height, width), np.int32)
    rows = np.arange(20, dtype=np.int32)
    depth[:20, :] = (19 - rows)[:, None]

    normal = np.zeros((height, width, 3), np.float32)
    normal[:20] = (0.0, 1.0, 0.0)
    normal[20:] = (0.0, 0.0, -1.0)

    return SpriteAtlas(
        color=color[None], depth=depth[None], normal=normal[None]
    )


def concat_atlases(*atlases: SpriteAtlas) -> SpriteAtlas:
    """Stack several single/multi-sprite atlases into one."""
    return SpriteAtlas(
        color=np.concatenate([a.color for a in atlases]),
        depth=np.concatenate([a.depth for a in atlases]),
        normal=np.concatenate([a.normal for a in atlases]),
    )
