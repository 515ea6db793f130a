"""Light geometry and the ambient + L1-Lambert shade on torch tensors.

Counterpart of ``pixel_art_raytracer_tpu/ops/shade.py`` (its non-integer
``light_geometry`` branch, ``factor_from_dot`` and the u8 scale).  Float
math stays float32 in the reference's op order (alternative.cpp:702-760):

* the towards-light direction is ``d / len`` and the inverse direction is
  ``1 / (d / len)`` — two roundings, never ``len / d``;
* the Lambert dot is separate eager multiplies and adds, so nothing
  contracts into an FMA (no ``addcmul``, no ``torch.compile``);
* ``std::min``/``std::max`` keep their argument order under NaN.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from .cstyle import c_div, c_max, c_min
from .trace import GBufferArrays


def light_geometry(gbuf: GBufferArrays, lights: torch.Tensor,
                   config: RenderConfig):
    """Per-pixel shadow-ray geometry (alternative.cpp:707-732).

    lights: (F, 3) int32, one point light per frame.  Returns
    ``(tl, inv, origin, rb, lb)``: the L1-normalised towards-light direction,
    its reciprocal, the float ray origin and the ray's start bin, each a
    3-tuple of (F, H, W) tensors, and the light's bin, a 3-tuple of
    (F, 1, 1) int32 tensors.
    """
    cfg = config
    bs = cfg.bin_size
    f32 = torch.float32
    F, H, W = gbuf.y.shape
    wx = torch.arange(W, dtype=torch.int32,
                      device=gbuf.y.device).expand(F, H, W).contiguous()
    wy, wz = gbuf.y, gbuf.z
    lx, ly, lz = (lights[:, a].view(F, 1, 1) for a in range(3))

    dx = lx.to(f32) - wx.to(f32)
    dy = ly.to(f32) - wy.to(f32)
    dz = lz.to(f32) - wz.to(f32)
    # L1 normalisation (sprites.hpp:28-35, quirk Q2).
    length = dx.abs() + dy.abs() + dz.abs()
    tl = (dx / length, dy / length, dz / length)
    inv = tuple(torch.reciprocal(t) for t in tl)

    # Bin coordinates (alternative.cpp:724-732), C-truncating division.
    rb = (c_div(wx, bs), c_div(cfg.view_height - wy - wz, bs), c_div(wz, bs))
    lb = (c_div(lx, bs), c_div(cfg.view_height - ly - lz, bs), c_div(lz, bs))
    origin = (wx.to(f32), wy.to(f32), wz.to(f32))
    return tl, inv, origin, rb, lb


def lambert_dot(normal: torch.Tensor, tl) -> torch.Tensor:
    """``n . tl`` as ``n0*t0 + n1*t1 + n2*t2``, left to right."""
    return (normal[..., 0] * tl[0] + normal[..., 1] * tl[1]
            + normal[..., 2] * tl[2])


def factor_from_dot(dot, lit, config: RenderConfig) -> torch.Tensor:
    """min(1, max(0, dot) + ambient) where lit, ambient elsewhere
    (alternative.cpp:734-758)."""
    ambient = config.ambient
    diffuse = c_max(torch.zeros_like(dot), dot)
    brightness = c_min(torch.ones_like(dot), diffuse + ambient)
    return torch.where(lit, brightness, torch.full_like(dot, ambient))


def shade_u8(color: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``Color * factor`` per RGB channel with C truncation to u8
    (sprites.hpp:8-16).  color (..., 4) uint8, factor (...)."""
    return (color[..., :3].to(torch.float32) * factor[..., None]).to(
        torch.uint8)
