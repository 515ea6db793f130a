"""Animated GIF writeback.

Counterpart of ``pixel_art_raytracer_tpu/utils/gif.py``: the same bytes for
the same frames, with either encoder.  The reference's only published
artifact is ``gif.gif``, a screen capture of its SDL window (README.org:4).
Here frames rendered on the card are fetched to the host and written
straight to GIF89a.

Quantisation: shaded frames are palette colors times a brightness factor, so
real frames contain few distinct colors.  We build an exact palette when the
frame set has <= 256 unique colors (always true for reference-parity scenes)
and fall back to a 6x7x6 uniform cube otherwise.

Encoding uses the native LZW encoder (``par_gif_write`` of
native/par_native.cpp, built at first use by ``runtime/native.py``) unless
the caller asks for the pure-Python encoder; the Python encoder also runs
when the native call returns failure, as in the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np


def quantize_frames(frames: np.ndarray):
    """Map (F, H, W, 3) uint8 RGB frames to (indexed_frames, palette).

    Returns (F, H, W) uint8 indices and (P, 3) uint8 palette, P <= 256.
    """
    f, h, w, _ = frames.shape
    flat = frames.reshape(-1, 3)
    colors, inverse = np.unique(flat, axis=0, return_inverse=True)
    if len(colors) <= 256:
        return inverse.reshape(f, h, w).astype(np.uint8), colors
    # Uniform 6x7x6 cube fallback.
    r = np.minimum(flat[:, 0].astype(np.int32) * 6 // 256, 5)
    g = np.minimum(flat[:, 1].astype(np.int32) * 7 // 256, 6)
    b = np.minimum(flat[:, 2].astype(np.int32) * 6 // 256, 5)
    idx = (r * 7 + g) * 6 + b
    rr, gg, bb = np.meshgrid(np.arange(6), np.arange(7), np.arange(6),
                             indexing="ij")
    palette = np.stack([(rr * 255 // 5), (gg * 255 // 6), (bb * 255 // 5)],
                       axis=-1).reshape(-1, 3).astype(np.uint8)
    return idx.reshape(f, h, w).astype(np.uint8), palette


def _lzw_encode_py(indices: np.ndarray, min_code_bits: int) -> bytes:
    """Pure-Python GIF LZW for one frame."""
    clear = 1 << min_code_bits
    eoi = clear + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def put(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {}
    code_bits = min_code_bits + 1
    next_code = eoi + 1
    put(clear, code_bits)
    data = indices.tobytes()
    prefix = data[0]
    for byte in data[1:]:
        key = (prefix << 8) | byte
        if key in table:
            prefix = table[key]
            continue
        put(prefix, code_bits)
        if next_code < 4096:
            table[key] = next_code
            if next_code == (1 << code_bits):
                code_bits += 1
            next_code += 1
        else:
            put(clear, code_bits)
            code_bits = min_code_bits + 1
            next_code = eoi + 1
            table = {}
        prefix = byte
    put(prefix, code_bits)
    put(eoi, code_bits)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif_py(path, frames_idx: np.ndarray, palette: np.ndarray,
                 delay_cs: int = 4, loop: int = 0) -> None:
    """Pure-Python GIF89a writer (same format as the native encoder)."""
    f, h, w = frames_idx.shape
    pal_bits = max(1, int(np.ceil(np.log2(max(2, len(palette))))))
    entries = 1 << pal_bits
    with open(path, "wb") as fp:
        fp.write(b"GIF89a")
        fp.write(struct.pack("<HHBBB", w, h, 0xF0 | (pal_bits - 1), 0, 0))
        pal = np.zeros((entries, 3), np.uint8)
        pal[: len(palette)] = palette
        fp.write(pal.tobytes())
        if f > 1:
            fp.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
                     + struct.pack("<H", loop) + b"\x00")
        min_code_bits = max(2, pal_bits)
        for k in range(f):
            fp.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs)
                     + b"\x00\x00")
            fp.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            fp.write(bytes([min_code_bits]))
            payload = _lzw_encode_py(frames_idx[k].reshape(-1), min_code_bits)
            for off in range(0, len(payload), 255):
                chunk = payload[off:off + 255]
                fp.write(bytes([len(chunk)]) + chunk)
            fp.write(b"\x00")
        fp.write(b"\x3b")


def write_gif(path, frames: np.ndarray, delay_cs: int = 4, loop: int = 0,
              prefer_native: bool = True) -> str:
    """Write (F, H, W, 3) uint8 RGB frames as an animated GIF.

    Uses the native LZW encoder unless ``prefer_native`` is False, and the
    Python one when the native call fails.  Returns which encoder ran
    ('native' or 'python').
    """
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim == 3:
        frames = frames[None]
    idx, palette = quantize_frames(frames)
    if prefer_native:
        from ..runtime.native import gif_write_native

        if gif_write_native(path, idx, palette, delay_cs, loop):
            return "native"
    write_gif_py(path, idx, palette, delay_cs, loop)
    return "python"
