"""Shadow rays on torch tensors: the plain version of kernel 2.

Counterpart of ``pixel_art_raytracer_tpu/ops/shadow.py::trace_light_dynamic``.
The reference marches each shadow ray through the hash grid with a thick
DDA that probes up to seven neighbour combinations per step (x, y, z, xy,
xz, yz, advance), so corner-adjacent bins are not missed
(``trace_hash_for_light``, alternative.cpp:399-500).  Here every pixel of
every frame marches at once, phase by phase, to the per-ray bound
``7 * int(largest)`` the reference computes; a pixel stops testing at its
bound or its first occluder.  It is what ``csrc/shadow.cu`` computes, and
what ``ops/shadow_cuda.trace_light`` runs for CPU tensors.

Flat bin indices outside [0, hash_volume) are skipped (the reference reads
out of bounds there); in-range aliased indices are used as they are, which
reproduces the reference's deterministic aliasing.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from .cstyle import c_max, c_min
from .trace import entity_pos

# Per-phase axis participation: x, y, z, xy, xz, yz, xyz-advance
# (alternative.cpp:432-466).
PHASE_AXES = (
    (True, False, False),
    (False, True, False),
    (False, False, True),
    (True, True, False),
    (True, False, True),
    (False, True, True),
    (True, True, True),
)


def trace_light_dynamic(pos, ext, bins_ent, counts, start_bin, end_bin,
                        start_ent, origin, inv_dir, players,
                        config: RenderConfig,
                        work: dict | None = None) -> torch.Tensor:
    """March every shadow ray; True where the light is reachable.

    Args:
      pos, ext: (N, 3) int32; players: (F, 3) entity 0's position per frame.
      bins_ent: (F, V, C) int32; counts: (F, V) int32.
      start_bin: (rbx, rby, rbz) int32 (F, H, W) ray-origin bins.
      end_bin: (lbx, lby, lbz) int32 light bins, broadcastable to (F, H, W).
      start_ent: (F, H, W) int32 originating entity (self-shadow skip).
      origin: (ox, oy, oz) float32 (F, H, W) world positions.
      inv_dir: (ix, iy, iz) float32 (F, H, W) reciprocal ray directions.
      work: when given, ``work["slab_tests"]`` is set to the number of slab
        tests the march makes on these inputs (each ray stops at its first
        occluder; a 0-d int64 tensor), for a bound on the kernel's time.
    """
    cfg = config
    cap = cfg.bin_capacity
    V = cfg.hash_volume
    f32 = torch.float32
    dev = bins_ent.device
    F = bins_ent.shape[0]

    rbx, rby, rbz = start_bin
    s = tuple(r.to(f32) for r in start_bin)
    d = tuple(lb.to(f32) - sa for lb, sa in zip(end_bin, s))
    largest = c_max(c_max(d[0].abs(), d[1].abs()), d[2].abs())
    step = tuple(da / largest for da in d)
    n_phases = 7 * largest.to(torch.int32)
    total = int(n_phases.max()) if n_phases.numel() else 0

    start_flat = (rbx * cfg.hash_height + rby) * cfg.hash_length + rbz
    frame = torch.arange(F, device=dev)[:, None, None]
    ox, oy, oz = origin
    ivx, ivy, ivz = inv_dir

    def slab_hit(ent):
        """Slab test with the reference's min/max chain
        (alternative.cpp:40-83)."""
        lo_b = entity_pos(pos, players, ent)
        hi_b = (lo_b + ext[ent.long()]).to(f32)
        lo_b = lo_b.to(f32)
        x1 = (lo_b[..., 0] - ox) * ivx
        x2 = (hi_b[..., 0] - ox) * ivx
        lo = c_min(x1, x2)
        hi = c_max(x1, x2)
        y1 = (lo_b[..., 1] - oy) * ivy
        y2 = (hi_b[..., 1] - oy) * ivy
        lo = c_max(lo, c_min(y1, y2))
        hi = c_min(hi, c_max(y1, y2))
        z1 = (lo_b[..., 2] - oz) * ivz
        z2 = (hi_b[..., 2] - oz) * ivz
        lo = c_max(lo, c_min(z1, z2))
        hi = c_min(hi, c_max(z1, z2))
        return hi >= lo

    t_cur = list(s)
    occluded = torch.zeros(rbx.shape, dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(total):
        axes = PHASE_AXES[t % 7]
        c = [tc + st if a else tc for tc, st, a in zip(t_cur, step, axes)]
        if all(axes):
            t_cur = c
        active = (t < n_phases) & ~occluded
        bx, by, bz = (ca.to(torch.int32) for ca in c)
        flat = (bx * cfg.hash_height + by) * cfg.hash_length + bz
        in_range = (flat >= 0) & (flat < V)
        flat_c = torch.where(in_range, flat, 0).long()
        test = active & in_range & (flat != start_flat)
        if not bool(test.any()):
            # No ray probes a bin this phase (all done, or outside the grid
            # as rays toward a far light mostly are): nothing to test.
            continue

        cnt = counts[frame, flat_c]
        for k in range(cap):
            ent = bins_ent[frame, flat_c, k]
            consider = test & (k < cnt) & (ent != start_ent)
            if work is not None:
                tests += (consider & ~occluded).sum()
            occluded = occluded | (consider
                                   & slab_hit(torch.where(ent >= 0, ent, 0)))
    if work is not None:
        work["slab_tests"] = tests
    return ~occluded
