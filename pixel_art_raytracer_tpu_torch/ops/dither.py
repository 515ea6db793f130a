"""Ordered-dither palette shading on torch tensors (BASELINE config 4).

Counterpart of ``pixel_art_raytracer_tpu/ops/dither.py``.  Instead of
scaling the palette colour by the brightness factor, the lit luminance is
re-quantised onto the palette with a Bayer threshold matrix.  Elementwise
torch ops on the card as on the CPU: the JAX package runs it as XLA glue,
with no kernel.

Luminance parity: the JAX code's ``rgb.astype(f32) @ weights`` is, on the
CPU, XLA's chain of fused multiply-adds ``fma(b, w2, fma(g, w1, r * w0))``,
each rounded to float32 once.  :func:`luminance` computes that chain: the
products and sums of u8 channels and float32 weights are exact in float64
(at most 32 significant bits a product, 53 a sum), so rounding each step to
float32 is the fma's single rounding.  A sequential ``r*w0 + g*w1 + b*w2``
or torch's ``@`` rounds differently on some colours, and a one-ulp
luminance moves a pixel across a Bayer threshold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ITU-R BT.601 luma weights, the float32 values of the JAX code (held as
# the Python floats that equal them).
LUMA_WEIGHTS = tuple(float(np.float32(w)) for w in (0.299, 0.587, 0.114))


def bayer_matrix(n: int = 4) -> np.ndarray:
    """Standard 2^k x 2^k Bayer matrix with thresholds in [0, 1)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"bayer_matrix: n={n} is not a power of two")
    m = np.zeros((1, 1), np.int32)
    size = 1
    while size < n:
        m = np.block([[4 * m + 0, 4 * m + 2],
                      [4 * m + 3, 4 * m + 1]])
        size *= 2
    return (m.astype(np.float32) + 0.5) / (size * size)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Luminance in [0, 1] of (..., 3) uint8 colours, float32:
    ``fma(b, w2, fma(g, w1, r * w0)) / 255`` with one float32 rounding per
    step (see the module docstring)."""
    f32, f64 = torch.float32, torch.float64
    w0, w1, w2 = LUMA_WEIGHTS
    c = rgb[..., :3].to(f64)
    acc = (c[..., 0] * w0).to(f32)
    acc = (c[..., 1] * w1 + acc.to(f64)).to(f32)
    acc = (c[..., 2] * w2 + acc.to(f64)).to(f32)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient.
    return acc / torch.full_like(acc, 255.0)


@functools.cache
def color_luminance(rgb: tuple[int, int, int]) -> float:
    """:func:`luminance` of one u8 colour ``(r, g, b)``, on the host: the
    float32 value as a Python float, with no device operation."""
    return float(luminance(torch.tensor(rgb, dtype=torch.uint8)))


def dither_to_palette(target: torch.Tensor, palette_luma: torch.Tensor,
                      n: int = 4, row0: int = 0) -> torch.Tensor:
    """Quantise per-pixel target luminance onto palette indices with ordered
    dithering.

    target: (..., H, W) float32 lit luminance in [0, 1]; palette_luma: (P,)
    float32 palette luminance in [0, 1], ascending; n: Bayer matrix size (a
    power of two); row0: the view row of the target's first row (a row
    window's).  Returns (..., H, W) int64 palette indices: the target
    lands between two palette entries and the Bayer threshold of the
    pixel's position picks which.
    """
    H, W = target.shape[-2:]
    P = palette_luma.shape[0]
    bayer = torch.from_numpy(bayer_matrix(n)).to(target.device)
    tile = bayer.repeat(-(-(row0 + H) // n), -(-W // n))[row0:row0 + H, :W]

    # The highest palette entry <= target (the lower neighbour).
    below = (palette_luma <= target[..., None]).sum(-1) - 1
    lo = below.clamp(0, P - 1)
    hi = (lo + 1).clamp(0, P - 1)
    luma_lo = palette_luma[lo]
    luma_hi = palette_luma[hi]
    span = torch.where(luma_hi > luma_lo, luma_hi - luma_lo,
                       torch.ones_like(luma_lo))
    frac = ((target - luma_lo) / span).clamp(0.0, 1.0)
    return torch.where(frac > tile, hi, lo)


def shade_dithered(gbuf_color: torch.Tensor, brightness: torch.Tensor,
                   palette_rgb: torch.Tensor, n: int = 4,
                   row0: int = 0) -> torch.Tensor:
    """Lit pixels re-quantised onto the palette.

    gbuf_color: (..., H, W, >=3) uint8 G-buffer colours; brightness:
    (..., H, W) float32 lighting factor in [0, 1]; palette_rgb: (P, 3)
    uint8, sorted by luminance; row0 as for :func:`dither_to_palette`.
    Returns (..., H, W, 3) uint8 frames made of palette colours only.
    """
    idx = dither_to_palette(luminance(gbuf_color) * brightness,
                            luminance(palette_rgb), n, row0)
    return palette_rgb[idx]
