"""The inputs both sides are handed: scene arrays and the sprite atlas.

A configuration's generator (``configs/<name>.py``) builds its scene as a
dict of numpy arrays (``pos``, ``ext``, ``sprite_id``, ``atlas_color``,
``atlas_depth``, ``atlas_normal``, ``palette``); the benchmark hands the
same arrays to the program and to the reference.
"""

from __future__ import annotations

import numpy as np


def tile_floor() -> dict[str, np.ndarray]:
    """The reference's one sprite, the 20x40 checkerboard floor tile
    (src/sprites.hpp:67-364), as a one-sprite atlas: the top face in rows
    0-19 (depth 19 - row, normal +y), the front face in rows 20-39 (depth
    0, normal -z)."""
    color = np.zeros((40, 20), np.int32)
    color[4:10, 4:10] = 2
    color[4:10, 10:16] = 3
    color[10:16, 4:10] = 3
    color[10:16, 10:16] = 2
    color[20:38, :] = 2
    color[20:38, :2] = 1
    color[20:38, 18:] = 1
    color[38:, :] = 1
    depth = np.zeros((40, 20), np.int32)
    depth[:20, :] = (19 - np.arange(20, dtype=np.int32))[:, None]
    normal = np.zeros((40, 20, 3), np.float32)
    normal[:20] = (0.0, 1.0, 0.0)
    normal[20:] = (0.0, 0.0, -1.0)
    return {"atlas_color": color[None], "atlas_depth": depth[None],
            "atlas_normal": normal[None]}


def scene_arrays(boxes: list[tuple[tuple[int, int, int],
                                   tuple[int, int, int]]],
                 config: dict) -> dict[str, np.ndarray]:
    """Scene arrays of ``(position, extent)`` boxes in insertion order,
    each skinned with the floor tile, and the configuration's palette."""
    n = len(boxes)
    pos = np.asarray([b[0] for b in boxes], np.int32).reshape(n, 3)
    ext = np.asarray([b[1] for b in boxes], np.int32).reshape(n, 3)
    return {"pos": pos, "ext": ext, "sprite_id": np.zeros(n, np.int32),
            **tile_floor(),
            "palette": np.asarray(config["palette"], np.uint8)}
