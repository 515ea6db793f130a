"""C-semantics numeric helpers on torch tensors.

Counterpart of ``pixel_art_raytracer_tpu/ops/cstyle.py``.  Pixel parity
with the C++ reference needs its numeric behaviours, several of which
differ from torch's defaults:

* ``std::min(a, b)`` is ``b < a ? b : a`` and ``std::max(a, b)`` is
  ``a < b ? b : a``: under NaN they keep ``a``, where ``torch.minimum``
  propagates NaN.
* C integer division truncates toward zero; torch's ``//`` floors.
* ``static_cast<unsigned char>(float)`` truncates toward zero.

Division is plain IEEE ``/`` on both the CPU and the card (the JAX
package's float64 emulation exists only for XLA:TPU's inexact divide).
"""

from __future__ import annotations

import numpy as np
import torch


def c_min(a, b):
    """``std::min(a, b)`` == ``b < a ? b : a`` (keeps ``a`` when unordered)."""
    return torch.where(b < a, b, a)


def c_max(a, b):
    """``std::max(a, b)`` == ``a < b ? b : a`` (keeps ``a`` when unordered)."""
    return torch.where(a < b, b, a)


def c_div(a, b):
    """C integer division: truncate toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def trunc_to_int(x: torch.Tensor) -> torch.Tensor:
    """``static_cast<int>(float)`` — truncation toward zero."""
    return x.to(torch.int32)


def scale_color_u8(color: torch.Tensor, factor) -> torch.Tensor:
    """``Color::operator*(float)`` (sprites.hpp:8-16): per-channel
    ``u8(float(channel) * factor)`` with C truncation."""
    return (color.to(torch.float32) * factor).to(torch.uint8)


def l1_normalize(x, y, z):
    """L1 ("Manhattan") normalisation — ``Vector::normalize``
    (sprites.hpp:28-35).  A zero length yields inf/NaN, as in the
    reference."""
    length = x.abs() + y.abs() + z.abs()
    return x / length, y / length, z / length


def normal_to_debug_color(nx: np.ndarray, ny: np.ndarray, nz: np.ndarray):
    """``Vector::operator Color`` (sprites.hpp:37-51): the reference's debug
    visualisation of a normal as an RGB color, on float32 numpy arrays.

    Shifts components positive by the L1 length, renormalises by the shifted
    sum, scales by 255 with C truncation.  Returns (r, g, b) uint8 arrays.

    It works on the host copy, as the JAX package's ``Session.normal_view``
    does: a background pixel's zero normal gives 0 / 0 = NaN, whose cast to
    uint8 is undefined and differs between numpy, torch on the CPU and
    CUDA, so only numpy reproduces the JAX package's bytes there.
    """
    length = np.abs(nx) + np.abs(ny) + np.abs(nz)
    px, py, pz = nx + length, ny + length, nz + length
    total = px + py + pz
    return tuple(((comp / total).astype(np.float32)
                  * np.float32(255)).astype(np.uint8)
                 for comp in (px, py, pz))
