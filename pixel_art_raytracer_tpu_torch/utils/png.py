"""Minimal dependency-free PNG writer (zlib from the stdlib).

Counterpart of ``pixel_art_raytracer_tpu/utils/png.py``: the same bytes for
the same image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None].repeat(3, axis=-1)
    h, w, _ = image.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    raw = b"".join(b"\x00" + image[r].tobytes() for r in range(h))
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))
