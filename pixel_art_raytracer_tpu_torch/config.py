"""Render configuration.

The port's own copy of ``pixel_art_raytracer_tpu/config.py`` (same names,
fields and defaults), so the port imports nothing of the JAX package.

The reference hard-codes every parameter as a ``constexpr`` global or an inline
literal (reference: src/alternative.cpp:116-131, ambient at alternative.cpp:702,
palette at src/sprites.hpp:60-65).  Here they live in one frozen, hashable
dataclass.

Defaults reproduce the reference exactly.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Palette of the one shipped asset (reference: src/sprites.hpp:60-65).
# RGBA; alpha defaults to 0 in the reference (value-initialised aggregate).
DEFAULT_PALETTE = (
    (100, 100, 100, 0),  # dark
    (140, 140, 140, 0),  # dark gray
    (200, 200, 200, 0),  # bright gray
    (240, 240, 240, 0),  # bright
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (frozen and hashable).

    Attributes mirror the reference constants:
      * ``bin_size``      — ``single_bin_cubic_size`` (alternative.cpp:116)
      * ``view_width/height/length`` — view frustum dims (alternative.cpp:117-119)
      * ``bin_capacity``  — ``sparse_bin_size`` (alternative.cpp:131); must be a
        power of two because bin occupancy wraps with ``& (capacity-1)``
        (alternative.cpp:259-264).
      * ``ambient``       — ambient light factor (alternative.cpp:702)
      * ``background``    — G-buffer clear color (alternative.cpp:281)
      * ``sprite_width/height`` — texel-map dims (sprites.hpp:68-70); width is
        hard-coded as ``20`` in the reference texel addressing
        (alternative.cpp:330).
    """

    view_width: int = 480
    view_height: int = 320
    view_length: int = 320
    bin_size: int = 40
    bin_capacity: int = 8
    sprite_width: int = 20
    sprite_height: int = 40
    ambient: float = 0.25
    background: tuple[int, int, int, int] = (127, 127, 127, 0)
    palette: tuple[tuple[int, int, int, int], ...] = DEFAULT_PALETTE
    # When True, primary rays stop after hitting entities in two bins without
    # an intervening empty bin (alternative.cpp:293-300, 368-374).  This is
    # observable culling, not just an optimisation — required for parity.
    early_exit: bool = True

    def __post_init__(self) -> None:
        if self.bin_capacity & (self.bin_capacity - 1):
            raise ValueError("bin_capacity must be a power of two")

    # Hash-grid dimensions (alternative.cpp:120-123).  The reference divides
    # exactly (480/320/320 by 40); non-multiple view sizes round the grid up
    # so every pixel's bin column exists.
    @property
    def hash_width(self) -> int:
        return -(-self.view_width // self.bin_size)

    @property
    def hash_height(self) -> int:
        return -(-self.view_height // self.bin_size)

    @property
    def hash_length(self) -> int:
        return -(-self.view_length // self.bin_size)

    @property
    def hash_volume(self) -> int:
        return self.hash_width * self.hash_height * self.hash_length

    @property
    def n_pixels(self) -> int:
        return self.view_width * self.view_height

    @cached_property
    def palette_array(self) -> np.ndarray:
        """Palette as a ``(n_colors, 4)`` uint8 array (RGBA)."""
        return np.asarray(self.palette, dtype=np.uint8)

    def bin_flat_index(self, x, y, z):
        """Row-major flat bin index: x-major, then y, then z.

        Matches ``index_into_view_hash`` (alternative.cpp:180-182).  Works on
        plain ints and on numpy arrays and tensors alike.  No bounds checking — the
        reference performs none either; callers that need the reference's
        aliasing-with-mask semantics handle that themselves.
        """
        return (x * self.hash_height + y) * self.hash_length + z


DEFAULT_CONFIG = RenderConfig()
