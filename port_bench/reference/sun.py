"""Plain PyTorch frames under a directional light with ordered-dither
palette shading (BASELINE config 4), one op at a time.

The reference C++ raytracer has one point light and scales the palette
colour by the brightness (``render.py``).  This deployment follows the
JAX package's definitions of its two extensions, read from its
``ops/shade.py::shade_directional``, ``ops/shadow_dir.py`` and
``ops/dither.py``; every frame is binned, traced and marched again from
the scene arrays with ``render.py``'s ``build_bins``, ``trace_winners``
and ``surface``.  The rules:

* the direction toward the light, per frame: ``tl = d / (|d0| + |d1| +
  |d2|)`` (summed left to right), its reciprocal ``1 / tl`` (two
  roundings), and the far-light offsets ``K = trunc(tl * span)``, ``span``
  twice the largest view dimension;
* each pixel marches from its surface point's bin toward its own virtual
  far light, the bin of the surface point moved by ``K``: ``c_div(x + Kx,
  bs)``, ``c_div(H - y - z - (Ky + Kz), bs)``, ``c_div(z + Kz, bs)``;
* the march is ``render.py``'s 7-phase DDA under the step cap
  ``hash_width + hash_height + 1 + hash_length``: a ray probes ``7 *
  min(int(largest), cap)`` phases; its slab test is ``render.lit_mask``'s
  in the same min/max order;
* the Lambert dot is against the frame's constant ``tl``, ``n0 t0 + n1 t1
  + n2 t2`` left to right; the factor is ``min(1, max(0, dot) + ambient)``
  where lit and ``ambient`` elsewhere;
* the dither: the luminance of a u8 colour is the fused chain
  ``fma(b, w2, fma(g, w1, r * w0)) / 255`` (the JAX code's ``rgb @ w``
  as XLA evaluates it on the CPU, with the float32 BT.601 weights), each
  step rounded once; the lit luminance (colour luminance times factor)
  lands between two palette entries ordered by luminance, and the Bayer
  threshold of the pixel's (row mod n, column mod n) picks the upper one
  where the fraction of the way between them exceeds it.

Departures from the JAX package: the palette is sorted by luminance here
(a stable sort; the JAX code takes it as given and requires that order);
and the view rows are the whole view's, as the batched path renders them.
Floats are ``fdt``, float32 for the reference and bfloat16 for the
control: every float step (direction, reciprocal, offsets, DDA, slab
test, dot, factor, luminance, fraction, thresholds) is rounded to it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .render import (PHASE_AXES, View, build_bins, c_div, c_max, c_min,
                     span_bound, surface, trace_winners, _entity_pos)

# ITU-R BT.601 luma weights, as float32 values.
LUMA_WEIGHTS = tuple(float(np.float32(w)) for w in (0.299, 0.587, 0.114))


def step_cap(view: View) -> int:
    """Thick-DDA steps after which a ray that starts in the grid has left
    it (``shade_directional``'s default ``max_steps``)."""
    gw, gh, gl = view.grid
    return gw + gh + 1 + gl


def direction_constants(directions, view: View, fdt):
    """``(tl, inv, K)`` of (F, 3) directions toward the light: the
    L1-normalised direction and its reciprocal in ``fdt``, and the
    far-light offsets (F, 3) int32."""
    d = directions.to(fdt)
    length = d[:, 0].abs() + d[:, 1].abs() + d[:, 2].abs()
    tl = d / length[:, None]
    inv = torch.reciprocal(tl)
    span = 2 * max(view.width, view.height, view.length)
    return tl, inv, (tl * span).to(torch.int32)


def _probes(start, end, view: View, fdt, cap: int):
    """``render._probes`` with the step cap: ``(flat, probe)`` phase by
    phase, each ray testing its first ``7 * min(int(largest), cap)``
    phases' bins that are in range and are not its start bin's flat."""
    _, gh, gl = view.grid
    s = tuple(a.to(fdt) for a in start)
    d = tuple(b.to(fdt) - a for b, a in zip(end, s))
    largest = c_max(c_max(d[0].abs(), d[1].abs()), d[2].abs())
    step = tuple(a / largest for a in d)
    n_phases = 7 * largest.to(torch.int32).clamp(max=cap)
    total = int(n_phases.max()) if n_phases.numel() else 0
    start_flat = (start[0] * gh + start[1]) * gl + start[2]
    cur = list(s)
    for t in range(total):
        axes = PHASE_AXES[t % 7]
        c = [a + st if on else a for a, st, on in zip(cur, step, axes)]
        if all(axes):
            cur = c
        bx, by, bz = (a.to(torch.int32) for a in c)
        flat = (bx * gh + by) * gl + bz
        yield flat, ((t < n_phases) & (flat >= 0) & (flat < view.volume)
                     & (flat != start_flat))


def lit_mask(scene, bins, counts, players, start, end, start_ent, origin,
             inv, view: View, fdt, cap: int):
    """True where no box of a probed bin (other than the ray's own) meets
    the ray: ``render.lit_mask`` over the capped probes."""
    pos, ext = scene["pos"], scene["ext"]
    F = bins.shape[0]
    frame = torch.arange(F, device=bins.device)[:, None, None]

    def slab_hit(ent):
        lo_b = _entity_pos(pos, players, ent)
        hi_b = (lo_b + ext[ent.long()]).to(fdt)
        lo_b = lo_b.to(fdt)
        lo = hi = None
        for a in range(3):
            t1 = (lo_b[..., a] - origin[a]) * inv[a]
            t2 = (hi_b[..., a] - origin[a]) * inv[a]
            if a == 0:
                lo, hi = c_min(t1, t2), c_max(t1, t2)
            else:
                lo, hi = c_max(lo, c_min(t1, t2)), c_min(hi, c_max(t1, t2))
        return hi >= lo

    occluded = torch.zeros(start[0].shape, dtype=torch.bool,
                           device=bins.device)
    for flat, probe in _probes(start, end, view, fdt, cap):
        test = probe & ~occluded
        if not bool(test.any()):
            continue
        flat_c = torch.where(probe, flat, 0).long()
        cnt = counts[frame, flat_c]
        for k in range(view.capacity):
            ent = bins[frame, flat_c, k]
            consider = test & (k < cnt) & (ent != start_ent)
            occluded |= consider & slab_hit(torch.where(ent >= 0, ent, 0))
    return ~occluded


def bayer_matrix(n: int, fdt, device) -> torch.Tensor:
    """The n x n Bayer matrix (n a power of two), thresholds ``(m + 0.5)
    / n**2`` in [0, 1)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"bayer_matrix: n={n} is not a power of two")
    m = np.zeros((1, 1), np.int64)
    while m.shape[0] < n:
        m = np.block([[4 * m, 4 * m + 2], [4 * m + 3, 4 * m + 1]])
    t = torch.as_tensor(m, device=device).to(fdt)
    return (t + 0.5) / torch.tensor(float(n * n), dtype=fdt, device=device)


def luminance(rgb: torch.Tensor, fdt) -> torch.Tensor:
    """Luminance of (..., >=3) uint8 colours: the fused chain of the
    module docstring, each step exact in float64 and rounded once to
    ``fdt``, then divided by 255."""
    f64 = torch.float64
    w0, w1, w2 = LUMA_WEIGHTS
    c = rgb[..., :3].to(f64)
    acc = (c[..., 0] * w0).to(fdt)
    acc = (c[..., 1] * w1 + acc.to(f64)).to(fdt)
    acc = (c[..., 2] * w2 + acc.to(f64)).to(fdt)
    return acc / torch.full_like(acc, 255.0)


def dither(color, factor, palette, n: int, fdt) -> torch.Tensor:
    """(F, H, W, 3) uint8 palette colours of (F, H, W, >=3) uint8 colours
    lit by (F, H, W) factors, ordered-dithered with the n x n Bayer
    matrix."""
    F, H, W = factor.shape
    pal_luma = luminance(palette, fdt)
    order = torch.argsort(pal_luma, stable=True)
    palette, pal_luma = palette[order, :3], pal_luma[order]
    P = pal_luma.shape[0]
    target = luminance(color, fdt) * factor
    bayer = bayer_matrix(n, fdt, factor.device)
    rows = torch.arange(H, device=factor.device) % n
    cols = torch.arange(W, device=factor.device) % n
    threshold = bayer[rows[:, None], cols[None, :]]
    lo = ((pal_luma <= target[..., None]).sum(-1) - 1).clamp(0, P - 1)
    hi = (lo + 1).clamp(0, P - 1)
    luma_lo, luma_hi = pal_luma[lo], pal_luma[hi]
    span = torch.where(luma_hi > luma_lo, luma_hi - luma_lo,
                       torch.ones_like(luma_lo))
    frac = ((target - luma_lo) / span).clamp(0.0, 1.0)
    return palette[torch.where(frac > threshold, hi, lo)]


def render_frames(scene: Mapping[str, torch.Tensor], players, directions,
                  view: View, fdt=torch.float32, bayer: int = 4):
    """The (F, H, W, 3) uint8 frames of players (F, 3) int32 and
    directions toward the light (F, 3) float32, on the scene's device,
    each frame binned, traced, marched and dithered from scratch."""
    pos, ext = scene["pos"], scene["ext"]
    dev = pos.device
    spans = span_bound(ext, view)
    tables = []
    for p in players:
        pos_f = pos.clone()
        pos_f[0] = p
        tables.append(build_bins(pos_f, ext, view, spans))
    bins = torch.stack([b for b, _ in tables])
    counts = torch.stack([c for _, c in tables])
    winner = trace_winners(scene, bins, counts, players, view)
    y, z, ent, texel = surface(scene, winner, players, view)

    # Each pixel's ray toward its virtual far light.
    F, H, W = winner.shape
    bs = view.bin_size
    tl, inv, K = direction_constants(directions, view, fdt)
    kx, ky, kz = (K[:, a].view(F, 1, 1) for a in range(3))
    wx = torch.arange(W, dtype=torch.int32, device=dev).expand(F, H, W)
    row = view.height - y - z
    start = (c_div(wx, bs), c_div(row, bs), c_div(z, bs))
    end = (c_div(wx + kx, bs), c_div(row - (ky + kz), bs), c_div(z + kz, bs))
    origin = tuple(t.to(fdt) for t in (wx, y, z))
    inv_f = tuple(inv[:, a].view(F, 1, 1) for a in range(3))
    lit = lit_mask(scene, bins, counts, players, start, end, ent, origin,
                   inv_f, view, fdt, step_cap(view))

    # The factor of the frame's constant direction, then the dither.
    hit = winner >= 0
    color = scene["palette"][scene["atlas_color"].reshape(-1)[texel].long()]
    bg = torch.tensor(view.background, dtype=torch.uint8, device=dev)
    color = torch.where(hit[..., None], color, bg)
    normal = torch.where(hit[..., None],
                         scene["atlas_normal"].reshape(-1, 3)[texel].to(fdt),
                         torch.zeros((), dtype=fdt, device=dev))
    t = tuple(tl[:, a].view(F, 1, 1) for a in range(3))
    dot = normal[..., 0] * t[0] + normal[..., 1] * t[1] \
        + normal[..., 2] * t[2]
    ambient = torch.full_like(dot, view.ambient)
    bright = c_min(torch.ones_like(dot),
                   c_max(torch.zeros_like(dot), dot) + ambient)
    factor = torch.where(lit, bright, ambient)
    return dither(color, factor, scene["palette"], bayer, fdt)
