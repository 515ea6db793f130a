"""ctypes binding of the repo's C++ oracle renderer (``native/par_native.cpp``).

The oracle is an independently written CPU renderer with the reference's
exact semantics; the tests and ``chip_smoke.py`` hold the port's frames
against it.  Only the entry points the port uses are bound:
:func:`cpp_build_bins`, :func:`cpp_trace_pixels`, :func:`cpp_shade`,
:func:`cpp_render_frame` and the GIF encoder that ``utils/gif.py`` writes
with (:func:`gif_write_native`).

The library is built with g++ at first use into ``build/native-<hash>/``,
the hash covering the source and the flags, with ``native/Makefile``'s
flags (``-ffp-contract=off``: no FMA contraction, so float results follow
the reference's IEEE op order).  A failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import NamedTuple

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from ..scene import Light, Scene

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCE = REPO / "native" / "par_native.cpp"
BUILD_ROOT = REPO / "build"
LIB_NAME = "libpar_native.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


class _ParConfig(ctypes.Structure):
    """``ParConfig`` of par_native.cpp."""

    _fields_ = [
        ("view_w", ctypes.c_int32), ("view_h", ctypes.c_int32),
        ("view_l", ctypes.c_int32), ("bin_size", ctypes.c_int32),
        ("bin_cap", ctypes.c_int32), ("sprite_w", ctypes.c_int32),
        ("sprite_h", ctypes.c_int32), ("ambient", ctypes.c_float),
        ("early_exit", ctypes.c_int32),
    ]

    @classmethod
    def from_config(cls, cfg: RenderConfig) -> "_ParConfig":
        return cls(cfg.view_width, cfg.view_height, cfg.view_length,
                   cfg.bin_size, cfg.bin_capacity, cfg.sprite_width,
                   cfg.sprite_height, cfg.ambient, int(cfg.early_exit))


class GBuffer(NamedTuple):
    """The oracle's G-buffer of one frame (the reference's ``Pixel``
    record, sprites.hpp:53-58)."""

    normal: np.ndarray        # (H, W, 3) float32
    color: np.ndarray         # (H, W, 4) uint8
    y: np.ndarray             # (H, W) int32
    z: np.ndarray             # (H, W) int32
    entity_index: np.ndarray  # (H, W) int32


def build_dir() -> pathlib.Path:
    """``build/native-<hash>``: the hash covers the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def build() -> pathlib.Path:
    """Build the library unless this hash's build exists; returns its path.

    Raises ``RuntimeError`` with g++'s output when the build fails.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the C++ oracle cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded oracle library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    cfg_p = ctypes.POINTER(_ParConfig)
    lib.par_build_bins.argtypes = [cfg_p, ctypes.c_int32, _i32p, _i32p,
                                   _i32p, _i32p]
    lib.par_build_bins.restype = None
    lib.par_trace_pixels.argtypes = [
        cfg_p, ctypes.c_int32, _i32p, _i32p, _i32p, _i32p, _i32p, _f32p,
        _u8p, _i32p, _i32p, _u8p, _f32p, _u8p, _i32p, _i32p, _i32p]
    lib.par_trace_pixels.restype = None
    lib.par_shade.argtypes = [
        cfg_p, _i32p, _i32p, _i32p, _i32p, _f32p, _u8p, _i32p, _i32p,
        _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p]
    lib.par_shade.restype = None
    lib.par_gif_write.argtypes = [
        ctypes.c_char_p, _u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.par_gif_write.restype = ctypes.c_int32
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def cpp_build_bins(scene: Scene, config: RenderConfig = DEFAULT_CONFIG):
    """The oracle's bin tables: ``(bins_ent (V, cap), counts (V,))``."""
    cfg = _ParConfig.from_config(config)
    bins_ent = np.empty((config.hash_volume, config.bin_capacity), np.int32)
    counts = np.empty(config.hash_volume, np.int32)
    library().par_build_bins(ctypes.byref(cfg), scene.n_entities,
                             _i32(scene.pos), _i32(scene.ext), bins_ent,
                             counts)
    return bins_ent, counts


def cpp_trace_pixels(scene: Scene, bins_ent, counts,
                     config: RenderConfig = DEFAULT_CONFIG) -> GBuffer:
    """The oracle's primary visibility into a :class:`GBuffer`."""
    cfg = _ParConfig.from_config(config)
    H, W = config.view_height, config.view_width
    out = GBuffer(normal=np.empty((H, W, 3), np.float32),
                  color=np.empty((H, W, 4), np.uint8),
                  y=np.empty((H, W), np.int32),
                  z=np.empty((H, W), np.int32),
                  entity_index=np.empty((H, W), np.int32))
    atlas = scene.atlas
    library().par_trace_pixels(
        ctypes.byref(cfg), scene.n_entities, _i32(scene.pos),
        _i32(scene.ext), _i32(scene.sprite_id), _i32(atlas.color),
        _i32(atlas.depth), np.ascontiguousarray(atlas.normal, np.float32),
        np.ascontiguousarray(config.palette_array, np.uint8),
        _i32(bins_ent), _i32(counts),
        np.ascontiguousarray(config.background, np.uint8), *out)
    return out


def cpp_shade(scene: Scene, gbuf: GBuffer, bins_ent, counts, light: Light,
              config: RenderConfig = DEFAULT_CONFIG) -> np.ndarray:
    """The oracle's shadowed shade of a G-buffer: (H, W, 3) uint8."""
    cfg = _ParConfig.from_config(config)
    out = np.empty((config.view_height, config.view_width, 3), np.uint8)
    library().par_shade(
        ctypes.byref(cfg), _i32(scene.pos), _i32(scene.ext), _i32(bins_ent),
        _i32(counts), np.ascontiguousarray(gbuf.normal, np.float32),
        np.ascontiguousarray(gbuf.color, np.uint8), _i32(gbuf.y),
        _i32(gbuf.z), _i32(gbuf.entity_index), light.x, light.y, light.z,
        out)
    return out


def cpp_render_frame(scene: Scene, light: Light,
                     config: RenderConfig = DEFAULT_CONFIG):
    """One oracle frame: ``(rgb (H, W, 3) uint8, GBuffer)``."""
    bins_ent, counts = cpp_build_bins(scene, config)
    gbuf = cpp_trace_pixels(scene, bins_ent, counts, config)
    return cpp_shade(scene, gbuf, bins_ent, counts, light, config), gbuf


def gif_write_native(path, frames_idx: np.ndarray, palette: np.ndarray,
                     delay_cs: int = 4, loop: int = 0) -> bool:
    """Encode palette-indexed frames to an animated GIF with the native LZW
    encoder (``par_gif_write``).  frames_idx: (F, H, W) uint8, palette:
    (P, 3) uint8.  Returns whether the library call succeeded (it refuses
    palettes of fewer than 2 or more than 256 colours, and paths it cannot
    open)."""
    f, h, w = frames_idx.shape
    rc = library().par_gif_write(str(path).encode(),
                                 np.ascontiguousarray(frames_idx, np.uint8),
                                 f, w, h,
                                 np.ascontiguousarray(palette, np.uint8),
                                 palette.shape[0], delay_cs, loop)
    return rc == 0
