"""The least work of the box filter (``csrc/filter.cu``), counted from a
cell's shapes as ``bounds.py`` counts the other kernels' (whose peaks it
takes)."""

from __future__ import annotations

from port_bench import bounds


def filter_bound_s(frames: int, height: int, width: int, s: int) -> float:
    """Reads the (F, H, W, 3) uint8 traced frames once and writes the
    (F, H / s, W / s, 3) filtered ones once; height and width are the
    traced sizes.  Its operations (s * s additions and a division a
    filtered byte) are not counted: they take under a tenth of the bytes'
    time at any s."""
    traced = 3 * frames * height * width
    return bounds.bound_s(traced + traced // (s * s), 0)
