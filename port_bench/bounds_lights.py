"""The least work of ``shadow.cu``'s multi-light mode in a batch, counted
from a cell's shapes as ``bounds.py`` counts the other kernels' (whose
peaks and bin tables it takes), whatever implements the stage."""

from __future__ import annotations

from port_bench import bounds

# A pixel's decode, once: ``bounds.SHADE_PIXEL_OPS``' 26 (the hit test and
# entity select, the player select, the row, the clamped texel, its
# address, the surface y and z, the start bin).
DECODE_OPS = 26
# Each light of a pixel: the ray's 3 subtractions, 3 absolute values, 2
# additions and 6 divisions, the Lambert dot's 3 multiplies and 2
# additions, the factor's 2 compares, 1 addition and 1 select, and the
# sum's subtraction of the ambient, max and addition.
LIGHT_OPS = 14 + 5 + 4 + 3
# The store, once: the total's addition and min, and the colour's 3
# multiplies and 3 truncations.
STORE_OPS = 2 + 6


def lights_bound_s(frames: int, height: int, width: int, volume: int,
                   capacity: int, lights: int) -> float:
    """The multi-light mode: reads the (F, H, W) int32 winners, the bin
    tables, the players (12 B a frame) and the lights (12 B a light a
    frame), writes the (F, H, W, 3) uint8 frames; a pixel's decode, each
    light's ray, dot, factor and sum, and the store."""
    pixels = frames * height * width
    n_bytes = (4 * pixels + bounds.bin_table_bytes(frames, volume, capacity)
               + 12 * frames + 12 * lights * frames + 3 * pixels)
    n_ops = (DECODE_OPS + LIGHT_OPS * lights + STORE_OPS) * pixels
    return bounds.bound_s(n_bytes, n_ops)
