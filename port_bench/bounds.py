"""The card's peaks and each kernel's least work, counted from a cell's
shapes, so the count does not depend on what implements a stage.

A bound is the larger of the bytes the kernel must move over the HBM rate
(each input byte read once, each output byte written once) and the
operations every pixel needs, whatever the scene, over the float32 rate
outside the tensor cores (integer operations are counted at that rate
too, so the bound stays a lower bound).  The march's slab tests depend on
the data and are not counted.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# The depth key of one candidate: its row, ey - row and its min with 0,
# the clamped texel row and column, the texel address, the key and its
# compare.  Every pixel's walk computes at least one.
DEPTH_KEY_OPS = 15
# A pixel of the winner-input mode, from its winner to its colour.  The
# decode: the hit test and entity select, the player select, the row (4),
# the clamped texel row and column (3), the texel address (4), the surface
# y (5) and z (2), the start bin (5): 26.  The shade: the ray's 3
# subtractions, 3 absolute values, 2 additions and 6 divisions, the
# Lambert dot's 3 multiplies and 2 additions, the factor's 2 compares, 1
# addition and 1 select, and the colour's 3 multiplies and 3
# truncations: 29.
SHADE_PIXEL_OPS = 26 + 29


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card takes for the work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S)


def bin_table_bytes(frames: int, volume: int, capacity: int) -> int:
    """Per-frame bin tables: (F, V, cap) entities and (F, V) counts,
    int32."""
    return 4 * frames * volume * (capacity + 1)


def trace_bound_s(frames: int, height: int, width: int, volume: int,
                  capacity: int) -> float:
    """``trace.cu``: reads the bin tables and the players, writes the
    (F, H, W) int32 winners; a depth key a pixel."""
    pixels = frames * height * width
    n_bytes = (bin_table_bytes(frames, volume, capacity) + 12 * frames
               + 4 * pixels)
    return bound_s(n_bytes, DEPTH_KEY_OPS * pixels)


def shade_bound_s(frames: int, height: int, width: int, volume: int,
                  capacity: int) -> float:
    """``shadow.cu``'s winner-input mode: reads the winners, the bin
    tables, the players and the lights, writes the (F, H, W, 3) uint8
    frames; a pixel's decode and shade."""
    pixels = frames * height * width
    n_bytes = (4 * pixels + bin_table_bytes(frames, volume, capacity)
               + 24 * frames + 3 * pixels)
    return bound_s(n_bytes, SHADE_PIXEL_OPS * pixels)
