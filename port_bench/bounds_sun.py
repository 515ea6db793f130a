"""The least work of the directional mode of ``shadow.cu`` in a batch,
counted from a cell's shapes as ``bounds.py`` counts the other kernels'
(whose peaks it takes)."""

from __future__ import annotations

from port_bench import bounds

# A pixel's ray, whatever the scene: the start bin's row H - y - z (2
# subtractions) and the start bin's three divisions by the bin size (3);
# the far light's bin, x + Kx, Ky + Kz, the row minus that sum and
# z + Kz (4) and their three divisions (3); the three differences light
# bin - start bin that set the walk (3); the origin's y and z as floats
# (2).
DIR_PIXEL_OPS = 5 + 7 + 3 + 2


def dir_march_bound_s(frames: int, height: int, width: int, volume: int,
                      capacity: int) -> float:
    """The directional mode: reads the bin tables, the G-buffer's y, z
    and entity (int32 each), each frame's reciprocal direction (3
    float32), far-light offsets K (3 int32) and player (3 int32), and
    writes the (F, H, W) lit mask, a byte a pixel; a pixel's ray."""
    pixels = frames * height * width
    n_bytes = (bounds.bin_table_bytes(frames, volume, capacity)
               + 12 * pixels + 36 * frames + pixels)
    return bounds.bound_s(n_bytes, DIR_PIXEL_OPS * pixels)
