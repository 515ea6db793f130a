"""Plain PyTorch frames of the reference raytracer under several point
lights a frame whose shadowed diffuse adds, built from ``render.py``'s
pieces.

The reference keeps a vector of lights (``src/alternative.cpp:619-626``)
and shades with its first (702-760); the sum is the framework extension
of the JAX package that this repo ports (``shade_multi``): every light
marches its own shadow rays from the frame's surface points, adds
``maximum(factor_l - ambient, 0)`` (a maximum that keeps NaN) to a sum
in light order, and the frame's factor is ``minimum(1, ambient + sum)``
(a minimum that keeps NaN), then the colour scaled with C truncation.
Each frame is binned, traced, marched light by light and shaded from
scratch; floats are ``fdt`` (float32 for the reference, bfloat16 for the
control).
"""

from __future__ import annotations

from typing import Mapping

import torch

from .render import (View, build_bins, c_div, c_max, c_min, lit_mask,
                     span_bound, surface, trace_winners)


def render_frames(scene: Mapping[str, torch.Tensor], players, lights,
                  view: View, fdt=torch.float32) -> torch.Tensor:
    """The (F, H, W, 3) uint8 frames of players (F, 3) and point lights
    (F, L, 3) int32 on the scene's device."""
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

    # Each light's shadow rays start at the surface point (707-732).
    F, H, W = winner.shape
    bs = view.bin_size
    wx = torch.arange(W, dtype=torch.int32, device=dev).expand(F, H, W)
    start = (c_div(wx, bs), c_div(view.height - y - z, bs), c_div(z, bs))
    origin = tuple(t.to(fdt) for t in (wx, y, z))
    hit = winner >= 0
    color = scene["palette"][scene["atlas_color"].reshape(-1)[texel].long()]
    bg = torch.tensor(view.background, dtype=torch.uint8, device=dev)
    color = torch.where(hit[..., None], color, bg)
    normal = torch.where(hit[..., None],
                         scene["atlas_normal"].reshape(-1, 3)[texel].to(fdt),
                         torch.zeros((), dtype=fdt, device=dev))
    ambient = torch.full((F, H, W), view.ambient, dtype=fdt, device=dev)
    zero = torch.zeros_like(ambient)
    diffuse = torch.zeros_like(ambient)
    for li in range(lights.shape[1]):
        lx, ly, lz = (lights[:, li, a].view(F, 1, 1) for a in range(3))
        d = tuple(l.to(fdt) - o for l, o in zip((lx, ly, lz), origin))
        length = d[0].abs() + d[1].abs() + d[2].abs()
        tl = tuple(a / length for a in d)
        inv = tuple(torch.reciprocal(a) for a in tl)
        end = (c_div(lx, bs), c_div(view.height - ly - lz, bs),
               c_div(lz, bs))
        lit = lit_mask(scene, bins, counts, players, start, end, ent,
                       origin, inv, view, fdt)
        # Ambient + L1 Lambert toward this light (734-758), its share over
        # the ambient added to the sum.
        dot = normal[..., 0] * tl[0] + normal[..., 1] * tl[1] \
            + normal[..., 2] * tl[2]
        bright = c_min(torch.ones_like(dot), c_max(zero, dot) + ambient)
        factor = torch.where(lit, bright, ambient)
        diffuse = diffuse + torch.maximum(factor - ambient, zero)
    total = ambient + diffuse
    factor = torch.minimum(torch.ones_like(total), total)
    return (color[..., :3].to(fdt) * factor[..., None]).to(torch.uint8)
