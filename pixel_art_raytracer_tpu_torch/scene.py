"""Scene assembly: entities = AABBs skinned with atlas sprites.

The port's own copy of ``pixel_art_raytracer_tpu/scene.py``.  The
reference's scene container (``Entities``, alternative.cpp:90-114) keeps
parallel vectors of ``AABB`` and 16 KB by-value ``Sprite`` copies; its
``insert`` ignores the sprite argument and always stores the floor tile
(alternative.cpp:105-108 — SURVEY.md quirk Q1).  Here a scene is a struct of
flat arrays (position, extent, sprite id) built on host and copied to device
tensors (``models/deferred.DeviceScene``).

Entity order matters: bin slot assignment and the wrap-at-8 overwrite are
insertion-order sensitive (alternative.cpp:259-264), so ``SceneBuilder``
preserves insertion order exactly, and ``graybox_world`` reproduces the
reference build loops (alternative.cpp:519-599) entity-for-entity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .assets import SpriteAtlas, make_tile_floor
from .config import RenderConfig, DEFAULT_CONFIG


@dataclasses.dataclass(frozen=True)
class Scene:
    """Frozen scene: SoA entity arrays + the sprite atlas.

    pos, ext: (N, 3) int32 world-space AABB position/extent (the reference
    stores int16; int32 is used on device — values are identical, int16 only
    narrowed storage).  sprite_id: (N,) int32 atlas indices.
    """

    pos: np.ndarray
    ext: np.ndarray
    sprite_id: np.ndarray
    atlas: SpriteAtlas

    @property
    def n_entities(self) -> int:
        return self.pos.shape[0]

    def replace_pos(self, pos) -> "Scene":
        return dataclasses.replace(self, pos=pos)


@dataclasses.dataclass(frozen=True)
class Light:
    """Point light (alternative.cpp:619-626).  ``radius`` is carried but
    unused by the shipped shading model, mirroring the reference."""

    x: int
    y: int
    z: int
    radius: int = 10

    def as_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], np.int32)


class SceneBuilder:
    """Host-side incremental scene construction (insertion order preserved)."""

    def __init__(self, atlas: SpriteAtlas | None = None,
                 config: RenderConfig = DEFAULT_CONFIG):
        self.atlas = atlas if atlas is not None else make_tile_floor()
        self.config = config
        self._pos: list[tuple[int, int, int]] = []
        self._ext: list[tuple[int, int, int]] = []
        self._sprite: list[int] = []

    def insert(self, position, extent, sprite_id: int = 0) -> int:
        """Append one entity; returns its index.

        Unlike the reference (quirk Q1), the sprite id is honoured.  Pass 0
        (the floor tile) for reference-parity scenes.
        """
        x, y, z = (int(v) for v in position)
        ex, ey, ez = (int(v) for v in extent)
        sw, sh = self.config.sprite_width, self.config.sprite_height
        if ex > sw or ey + ez > sh:
            # The reference would index past the 20x40 texel map
            # (alternative.cpp:324-341) — reject instead of silently OOB.
            raise ValueError(
                f"entity extent {extent} exceeds sprite map {sw}x{sh}: "
                f"need ext.x <= {sw} and ext.y + ext.z <= {sh}"
            )
        self._pos.append((x, y, z))
        self._ext.append((ex, ey, ez))
        self._sprite.append(int(sprite_id))
        return len(self._pos) - 1

    def build(self) -> Scene:
        n = len(self._pos)
        return Scene(
            pos=np.asarray(self._pos, np.int32).reshape(n, 3),
            ext=np.asarray(self._ext, np.int32).reshape(n, 3),
            sprite_id=np.asarray(self._sprite, np.int32).reshape(n),
            atlas=self.atlas,
        )


def graybox_world(config: RenderConfig = DEFAULT_CONFIG) -> Scene:
    """The reference demo world (alternative.cpp:519-599), 162,308 entities.

    Entity 0 is the player box; then the tiled floor with a 12-tile hole, the
    left wall stack, the right wall, and a beam row — in exactly the reference
    insertion order.
    """
    vw, vh, vl = config.view_width, config.view_height, config.view_length
    b = SceneBuilder(config=config)

    # Player (alternative.cpp:520-523).
    b.insert((vw // 2, 36, vl // 4), (20, 20, 20))

    # Floor grid with a hole near centre (alternative.cpp:527-547).
    for i in range(vw):
        for j in range(vl):
            x, z = i * 20, j * 20
            if (vw // 2 - 40 <= x < vw // 2 + 40
                    and vl // 2 - 40 < z < vl // 2 + 40):
                continue
            b.insert((x, 0, z), (20, 20, 20))

    # Left wall stack (alternative.cpp:549-568).
    for i in range(6):
        for j in range(vl - 10):
            for k in range(1, 6):
                if i >= 4 and k >= 4:
                    continue
                b.insert((i * 20, k * 20, vl - j * 20), (20, 20, 20))

    # Right wall (alternative.cpp:570-584).
    for i in range(1, 3):
        for j in range(vl):
            b.insert((vw - i * 20, 20, j * 20), (20, 20, 20))

    # Beam row (alternative.cpp:586-598).
    for i in range(1, 20):
        b.insert((vw - 40 - i * 20, 20, vl - 60), (20, 20, 20))

    return b.build()


def default_light(config: RenderConfig = DEFAULT_CONFIG) -> Light:
    """The reference's single light (alternative.cpp:624-626)."""
    return Light(config.view_width, config.view_height // 2,
                 config.view_length // 4)


def demo_world(n_side: int = 10, config: RenderConfig = DEFAULT_CONFIG) -> Scene:
    """A small deterministic scene (~n_side^2 boxes) for tests and demos."""
    b = SceneBuilder(config=config)
    b.insert((config.view_width // 2, 36, config.view_length // 4), (20, 20, 20))
    for i in range(n_side):
        for j in range(n_side):
            y = 20 if (i * 7 + j * 3) % 5 == 0 else 0
            b.insert((i * 20, y, j * 20), (20, 20, 20))
    return b.build()
