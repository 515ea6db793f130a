"""Plain PyTorch frames of the reference raytracer, one op at a time.

Line references are to Cons-Cat/Pixel-Art-Raytracer ``src/alternative.cpp``
and ``src/sprites.hpp``.  Every frame is rebuilt from the scene arrays:
its own hash grid (the serial scatter loop of ``count_entities_in_bins``,
195-269, as a stable sort by bin with the wrap-at-capacity overwrite), its
primary walk (``trace_hash_for_pixel``, 271-397), its shadow march
(``trace_hash_for_light``, 399-500) and its shade (702-760).

Numeric rules that parity with the C++ needs: ``std::min(a, b)`` is ``b <
a ? b : a`` and ``std::max(a, b)`` is ``a < b ? b : a``; integer division
truncates toward zero; float to u8 truncates; the towards-light direction
is ``d / len`` (L1 length) and its inverse ``1 / (d / len)``; the Lambert
dot is separate multiplies and adds, so nothing contracts into an FMA.
Floats are ``fdt`` (float32 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

INT32_MIN = torch.iinfo(torch.int32).min

# Per-phase axis participation of the thick DDA: x, y, z, xy, xz, yz, then
# the xyz advance (alternative.cpp:432-466).
PHASE_AXES = ((True, False, False), (False, True, False),
              (False, False, True), (True, True, False),
              (True, False, True), (False, True, True), (True, True, True))


@dataclasses.dataclass(frozen=True)
class View:
    """The renderer's constants (alternative.cpp:116-131, 281, 702)."""

    width: int
    height: int
    length: int
    bin_size: int
    capacity: int
    sprite_width: int
    sprite_height: int
    ambient: float
    background: tuple[int, int, int, int]
    early_exit: bool = True

    @property
    def grid(self) -> tuple[int, int, int]:
        bs = self.bin_size
        return (-(-self.width // bs), -(-self.height // bs),
                -(-self.length // bs))

    @property
    def volume(self) -> int:
        gw, gh, gl = self.grid
        return gw * gh * gl

    def scaled(self, s: int) -> "View":
        """The view, bin and sprite maps s times larger (supersampling)."""
        return dataclasses.replace(
            self, width=self.width * s, height=self.height * s,
            length=self.length * s, bin_size=self.bin_size * s,
            sprite_width=self.sprite_width * s,
            sprite_height=self.sprite_height * s)


def c_min(a, b):
    return torch.where(b < a, b, a)


def c_max(a, b):
    return torch.where(a < b, b, a)


def c_div(a, b):
    return torch.div(a, b, rounding_mode="trunc")


# -- the hash grid -----------------------------------------------------------

def span_bound(ext: torch.Tensor, view: View) -> tuple[int, int, int]:
    """How many bins one entity can cover per axis, from the largest
    extents; y shears with z, so its bound uses ey + ez."""
    ex, ey, ez = (int(v) for v in ext.max(dim=0).values.tolist())
    bs = view.bin_size
    return ex // bs + 2, (ey + ez) // bs + 2, ez // bs + 2


def covered_bins(pos, ext, view: View, spans):
    """Flat ids of the bins each entity covers and whether each is valid,
    (..., K) each, offsets nested x, y, z (alternative.cpp:212-245)."""
    bs, vh = view.bin_size, view.height
    gw, gh, gl = view.grid
    x0, y0, z0 = pos.unbind(-1)
    ex, ey, ez = ext.unbind(-1)
    x1, y1, z1 = x0 + ex, y0 + ey, z0 + ez
    culled = ((x1 < 0) | (x0 >= view.width) | (y1 < -z1)
              | (y0 >= vh - z0 + bs) | (z1 < -ez - bs)
              | (z0 > view.length + bs))
    lo = (c_div(x0, bs).clamp(min=0), c_div(vh - y1 - z1, bs).clamp(min=0),
          c_div(z0, bs).clamp(min=0))
    hi = (c_div(x1 + bs - 1, bs).clamp(max=gw),
          c_div(vh - y0 - z0 + bs - 1, bs).clamp(max=gh),
          c_div(z1 + bs - 1, bs).clamp(max=gl))
    offs = np.meshgrid(*(np.arange(s) for s in spans), indexing="ij")
    offs = [torch.as_tensor(o.reshape(-1), dtype=torch.int32,
                            device=pos.device) for o in offs]
    b = [lo_a[..., None] + o for lo_a, o in zip(lo, offs)]
    valid = ~culled[..., None]
    for b_a, hi_a in zip(b, hi):
        valid = valid & (b_a < hi_a[..., None])
    return (b[0] * gh + b[1]) * gl + b[2], valid


def build_bins(pos, ext, view: View, spans):
    """One frame's hash grid: ``(bins (V, cap), counts (V,))`` int32, -1 in
    empty slots.  Insertions into a bin keep entity order; the last
    ``capacity`` of them survive the wrap, entry r in slot r & (cap - 1),
    and the visible count is the total & (cap - 1) (259-264)."""
    V, cap = view.volume, view.capacity
    K = spans[0] * spans[1] * spans[2]
    flat, valid = covered_bins(pos, ext, view, spans)
    flat = torch.where(valid, flat, V).reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_bin = flat[order]
    idx = torch.arange(flat.numel(), device=pos.device)
    first = torch.ones_like(sorted_bin, dtype=torch.bool)
    first[1:] = sorted_bin[1:] != sorted_bin[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    totals = torch.bincount(flat, minlength=V + 1)
    keep = (sorted_bin < V) & (rank >= totals[sorted_bin] - cap)
    target = torch.where(keep, sorted_bin * cap + (rank & (cap - 1)),
                         V * cap)
    bins = torch.full((V * cap + 1,), -1, dtype=torch.int32,
                      device=pos.device)
    bins[target] = (order // K).to(torch.int32)
    return (bins[:V * cap].reshape(V, cap),
            (totals[:V] & (cap - 1)).to(torch.int32))


# -- primary visibility ------------------------------------------------------

def _pixels(view: View, device):
    """Column i (1, 1, W), row j (1, H, 1) and world row H - j."""
    i = torch.arange(view.width, dtype=torch.int32, device=device)
    j = torch.arange(view.height, dtype=torch.int32, device=device)
    return i[None, None, :], j[None, :, None], view.height - j[None, :, None]


def _entity_pos(pos, players, ent):
    """``pos[ent]`` with entity 0 at its frame's player position."""
    p = pos[ent.long()]
    pl = players.view((players.shape[0],) + (1,) * (ent.dim() - 1) + (3,))
    return torch.where((ent == 0)[..., None], pl, p)


def _texel(sid, row, col, view: View):
    """Clipped texel address in the flat atlas (324-341)."""
    sh, sw = view.sprite_height, view.sprite_width
    return ((sid * sh + row.clamp(0, sh - 1)) * sw
            + col.clamp(0, sw - 1)).long()


def trace_winners(scene, bins, counts, players, view: View):
    """Each pixel's winning entity (F, H, W) int32, -1 for background.

    Walks the pixel's bin column front to back, a bin's live slots in
    order; the strictly greater depth key wins (ties keep the earlier
    candidate); two bins with hits and no empty bin between stop the walk
    (293-300, 368-374)."""
    pos, ext, sid = scene["pos"], scene["ext"], scene["sprite_id"]
    dev = bins.device
    F = bins.shape[0]
    H, W = view.height, view.width
    _, gh, gl = view.grid
    i, j, wj = _pixels(view, dev)
    base = ((i // view.bin_size) * gh + j // view.bin_size) * gl
    frame = torch.arange(F, device=dev)[:, None, None]
    depth_flat = scene["atlas_depth"].reshape(-1)
    best = torch.full((F, H, W), INT32_MIN, dtype=torch.int32, device=dev)
    winner = torch.full((F, H, W), -1, dtype=torch.int32, device=dev)
    run = torch.zeros((F, H, W), dtype=torch.int32, device=dev)
    stopped = torch.zeros((F, H, W), dtype=torch.bool, device=dev)
    for bz in range(gl):
        flat = (base + bz).long()
        cnt = counts[frame, flat]
        active = ~stopped
        run = torch.where(active & (cnt == 0), 0, run)
        bin_hit = torch.zeros((F, H, W), dtype=torch.bool, device=dev)
        for k in range(view.capacity):
            valid = active & (k < cnt)
            ent = torch.where(valid, bins[frame, flat, k], 0)
            px, py, pz = _entity_pos(pos, players, ent).unbind(-1)
            ex, ey, ez = ext[ent.long()].unbind(-1)
            hit = (valid & (i >= px) & (i < px + ex) & (wj > py + pz)
                   & (wj <= py + ey + pz + ez))
            row = py + ey + pz + ez - wj
            texel = _texel(sid[ent.long()], row, i - px, view)
            depth = py - pz + (ey - row).clamp(max=0) - depth_flat[texel]
            better = hit & (depth > best)
            best = torch.where(better, depth, best)
            winner = torch.where(better, ent, winner)
            bin_hit |= better
        run = run + bin_hit.to(torch.int32)
        if view.early_exit:
            stopped = stopped | (active & (run >= 2))
    return winner


def surface(scene, winner, players, view: View):
    """The hit's world y, z, entity and texel per pixel (background: 0,
    0, 0 and entity 0's texel, as the reference's cleared G-buffer)."""
    pos, ext = scene["pos"], scene["ext"]
    i, _, wj = _pixels(view, winner.device)
    hit = winner >= 0
    ent = torch.where(hit, winner, 0)
    px, py, pz = _entity_pos(pos, players, ent).unbind(-1)
    _, ey, ez = ext[ent.long()].unbind(-1)
    row = py + ey + pz + ez - wj
    texel = _texel(scene["sprite_id"][ent.long()], row, i - px, view)
    sdep = scene["atlas_depth"].reshape(-1)[texel]
    y = torch.where(hit, py + ey + ez - row - sdep, 0)
    z = torch.where(hit, pz + sdep, 0)
    return y, z, ent, texel


# -- the shadow march --------------------------------------------------------

def _probes(start, end, view: View, fdt):
    """The DDA's probes phase by phase: ``(flat, probe)``, each ray testing
    the bins of its first ``7 * int(largest)`` phases that are in range
    and are not its start bin's flat (aliased flats included)."""
    _, gh, gl = view.grid
    s = tuple(a.to(fdt) for a in start)
    d = tuple(b.to(fdt) - a for b, a in zip(end, s))
    largest = c_max(c_max(d[0].abs(), d[1].abs()), d[2].abs())
    step = tuple(a / largest for a in d)
    n_phases = 7 * largest.to(torch.int32)
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
             inv, view: View, fdt):
    """True where no box of a probed bin (other than the ray's own) hits
    the ray: the slab test of 40-83 in its min/max order."""
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
    for flat, probe in _probes(start, end, view, fdt):
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


# -- frames ------------------------------------------------------------------

def render_frames(scene: Mapping[str, torch.Tensor], players, lights,
                  view: View, fdt=torch.float32, with_surface=False):
    """The (F, H, W, 3) uint8 frames of players (F, 3) and point lights
    (F, 3) int32 on the scene's device, each frame binned, traced, marched
    and shaded from scratch.  With ``with_surface``, also the surface's
    world y and z (F, H, W) int32, which the debug line starts from."""
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

    # Shadow rays from the surface point toward the light (707-732).
    F, H, W = winner.shape
    bs = view.bin_size
    wx = torch.arange(W, dtype=torch.int32, device=dev).expand(F, H, W)
    start = (c_div(wx, bs), c_div(view.height - y - z, bs), c_div(z, bs))
    origin = tuple(t.to(fdt) for t in (wx, y, z))
    lx, ly, lz = (lights[:, a].view(F, 1, 1) for a in range(3))
    d = tuple(l.to(fdt) - o for l, o in zip((lx, ly, lz), origin))
    length = d[0].abs() + d[1].abs() + d[2].abs()
    tl = tuple(a / length for a in d)
    inv = tuple(torch.reciprocal(a) for a in tl)
    end = (c_div(lx, bs), c_div(view.height - ly - lz, bs), c_div(lz, bs))
    lit = lit_mask(scene, bins, counts, players, start, end, ent, origin,
                   inv, view, fdt)

    # Ambient + L1 Lambert, colour scaled with C truncation (734-760).
    hit = winner >= 0
    color = scene["palette"][scene["atlas_color"].reshape(-1)[texel].long()]
    bg = torch.tensor(view.background, dtype=torch.uint8, device=dev)
    color = torch.where(hit[..., None], color, bg)
    normal = torch.where(hit[..., None],
                         scene["atlas_normal"].reshape(-1, 3)[texel].to(fdt),
                         torch.zeros((), dtype=fdt, device=dev))
    dot = normal[..., 0] * tl[0] + normal[..., 1] * tl[1] \
        + normal[..., 2] * tl[2]
    ambient = torch.full_like(dot, view.ambient)
    bright = c_min(torch.ones_like(dot),
                   c_max(torch.zeros_like(dot), dot) + ambient)
    factor = torch.where(lit, bright, ambient)
    frames = (color[..., :3].to(fdt) * factor[..., None]).to(torch.uint8)
    return (frames, y, z) if with_surface else frames


def box_filter(frame: torch.Tensor, s: int) -> torch.Tensor:
    """The truncated mean of each s x s block of an (H s, W s, 3) uint8
    frame: (H, W, 3).  The float32 sum of s * s bytes is exact and is
    divided by a tensor, an IEEE division on any device."""
    h, w = frame.shape[0] // s, frame.shape[1] // s
    total = frame.to(torch.float32).reshape(h, s, w, s, 3).sum(dim=(1, 3))
    count = torch.tensor(float(s * s), device=frame.device)
    return (total / count).to(torch.uint8)


def draw_line(image: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              color) -> None:
    """The reference's Bresenham walk (139-175) from (x0, y0) to its end,
    plotting the points inside the image (the call site's check, 762-772).
    Writes ``image`` (H, W, 3) in place."""
    H, W = image.shape[:2]
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err, x, y = dx + dy, x0, y0
    while True:
        if 0 <= x < W and 0 <= y < H:
            image[y, x] = color
        if x == x1 and y == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            if x == x1:
                return
            err += dy
            x += sx
        if e2 <= dx:
            if y == y1:
                return
            err += dx
            y += sy


def scale_scene(arrays: Mapping[str, np.ndarray], s: int) -> dict:
    """Scene arrays with the world scaled by s: positions and extents
    times s, each texel an s x s block, depth offsets in world units (a
    sprite whose depth falls by ``slope`` a row from ``d0`` gets ``max(0,
    s d0 + s - 1 - slope r)``, a flat one ``s d0``)."""
    out = dict(arrays)
    out["pos"] = arrays["pos"] * s
    out["ext"] = arrays["ext"] * s
    for key in ("atlas_color", "atlas_normal"):
        out[key] = np.repeat(np.repeat(arrays[key], s, axis=1), s, axis=2)
    depth = np.asarray(arrays["atlas_depth"]).astype(np.int64)
    S, H, W = depth.shape
    d0 = depth[:, 0, 0]
    slope = depth[:, 0, 0] - depth[:, 1, 0] if H > 1 else np.zeros(S, int)
    rows = np.arange(H)[None, :, None]
    ramp = np.maximum(0, d0[:, None, None] - slope[:, None, None] * rows)
    if (ramp == depth).all():
        big = np.arange(H * s)[None, :, None]
        scaled = np.maximum(0, (s * d0 + s - 1)[:, None, None]
                            - slope[:, None, None] * big)
        scaled = np.broadcast_to(scaled, (S, H * s, W * s)).copy()
        scaled[slope == 0] = (s * d0[slope == 0])[:, None, None]
    else:
        scaled = np.repeat(np.repeat(depth, s, axis=1), s, axis=2) * s
    out["atlas_depth"] = scaled.astype(np.int32)
    return out
