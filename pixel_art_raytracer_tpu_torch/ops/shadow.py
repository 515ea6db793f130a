"""Shadow rays on torch tensors: the plain version of kernel 2.

Counterpart of ``pixel_art_raytracer_tpu/ops/shadow.py::trace_light_dynamic``.
The reference marches each shadow ray through the hash grid with a thick
DDA that probes up to seven neighbour combinations per step (x, y, z, xy,
xz, yz, advance), so corner-adjacent bins are not missed
(``trace_hash_for_light``, alternative.cpp:399-500).  Here every pixel of
every frame marches at once, phase by phase, to the per-ray bound
``7 * int(largest)`` the reference computes, or to ``7 * max_steps`` where
a step cap is given (the directional march of ``shade_directional``); a
pixel stops testing at its bound or its first occluder.  It is what
``csrc/shadow.cu`` computes, and what ``ops/shadow_cuda`` runs for CPU
tensors.

Flat bin indices outside [0, hash_volume) are skipped (the reference reads
out of bounds there); in-range aliased indices are used as they are, which
reproduces the reference's deterministic aliasing.

The bins a ray probes depend only on its start bin, the light's bin and the
step cap, and a ray is occluded when any box of any probed bin hits it, an
OR that ignores order and repeats.  :func:`dda_visit_lists` gives each
(start bin, light bin) key's distinct probed bins in first-visit order: the
lists the CUDA kernels build once per tile and test every pixel of that key
against.
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


def dda_probes(start_bin, end_bin, config: RenderConfig,
               max_steps: int | None = None):
    """Yield the reference's DDA probes phase by phase: ``(flat, probe)``.

    start_bin: (sx, sy, sz) int32 tensors of one shape; end_bin: the light
    bins, broadcastable to it.  ``flat`` is the flat bin each ray's phase
    lands on (int32) and ``probe`` the rays that test it: the phase is
    within the ray's ``7 * min(int(largest), max_steps)`` phases (no cap
    for ``None``) and the flat is in range and not the start bin's flat
    (aliased flats included).
    """
    cfg = config
    f32 = torch.float32
    rbx, rby, rbz = start_bin
    s = tuple(r.to(f32) for r in start_bin)
    d = tuple(lb.to(f32) - sa for lb, sa in zip(end_bin, s))
    largest = c_max(c_max(d[0].abs(), d[1].abs()), d[2].abs())
    step = tuple(da / largest for da in d)
    n_steps = largest.to(torch.int32)
    if max_steps is not None:
        n_steps = n_steps.clamp(max=max_steps)
    n_phases = 7 * n_steps
    total = int(n_phases.max()) if n_phases.numel() else 0
    start_flat = (rbx * cfg.hash_height + rby) * cfg.hash_length + rbz

    t_cur = list(s)
    for t in range(total):
        axes = PHASE_AXES[t % 7]
        c = [tc + st if a else tc for tc, st, a in zip(t_cur, step, axes)]
        if all(axes):
            t_cur = c
        bx, by, bz = (ca.to(torch.int32) for ca in c)
        flat = (bx * cfg.hash_height + by) * cfg.hash_length + bz
        yield flat, ((t < n_phases) & (flat >= 0)
                     & (flat < cfg.hash_volume) & (flat != start_flat))


def dda_first_visits(start_bin, end_bin, config: RenderConfig,
                     max_steps: int | None = None):
    """Each ray's first probe of each bin.

    Arguments as :func:`dda_probes`, each start component of shape (P,).
    Returns ``(flats, first)``, both (T, P) for the T phases: the flat bin
    of each phase (int64) and True where the phase probes a bin that the
    ray has not probed before.
    """
    V = config.hash_volume
    P = start_bin[0].shape[0]
    rows = torch.arange(P, device=start_bin[0].device)
    seen = torch.zeros((P, V + 1), dtype=torch.bool,
                       device=start_bin[0].device)
    flats, first = [], []
    for flat, probe in dda_probes(start_bin, end_bin, config, max_steps):
        flat = torch.where(probe, flat, V).long()  # V: a column never read
        new = probe & ~seen[rows, flat]
        seen[rows, flat] = True
        flats.append(flat)
        first.append(new)
    if not flats:
        empty = torch.zeros((0, P), device=rows.device)
        return empty.long(), empty.bool()
    return torch.stack(flats), torch.stack(first)


def dda_visit_lists(start_bins, light_bin, config: RenderConfig,
                    max_steps: int | None = None) -> list[list[int]]:
    """The distinct flat bins each start bin's DDA probes, in first-visit
    order.

    start_bins: (sx, sy, sz) int32 tensors of shape (P,); light_bin: the
    light's bin (three ints or tensors broadcastable to (P,)); max_steps as
    :func:`dda_probes`.  Returns one list per start.  Testing a ray's boxes
    over its start's list gives the lit bit of :func:`trace_light_dynamic`
    (an OR over the same bins).
    """
    dev = start_bins[0].device
    end = tuple(torch.as_tensor(lb, dtype=torch.int32, device=dev)
                for lb in light_bin)
    flats, first = dda_first_visits(start_bins, end, config, max_steps)
    return [flats[first[:, p], p].tolist() for p in range(flats.shape[1])]


def _first_probes(start_bin, end_bin, shape, config: RenderConfig,
                  max_steps: int | None):
    """``first(t)``: the (F, H, W) mask of rays whose probe at phase t is
    their first of its bin, from :func:`dda_first_visits` over the distinct
    (start bin, light bin) keys (either may vary per pixel)."""
    keys = torch.stack([t.expand(shape).reshape(-1)
                        for t in (*start_bin, *end_bin)], dim=1)
    ukeys, inverse = torch.unique(keys, dim=0, return_inverse=True)
    _, first = dda_first_visits(tuple(ukeys[:, :3].unbind(1)),
                                tuple(ukeys[:, 3:].unbind(1)), config,
                                max_steps)
    return lambda t: first[t][inverse].view(shape)


def trace_light_dynamic(pos, ext, bins_ent, counts, start_bin, end_bin,
                        start_ent, origin, inv_dir, players,
                        config: RenderConfig,
                        work: dict | None = None,
                        max_steps: int | None = None,
                        live: torch.Tensor | None = None) -> torch.Tensor:
    """March every shadow ray; True where the light is reachable.

    Args:
      pos, ext: (N, 3) int32; players: (F, 3) entity 0's position per frame.
      bins_ent: (F, V, C) int32; counts: (F, V) int32.
      start_bin: (rbx, rby, rbz) int32 (F, H, W) ray-origin bins.
      end_bin: (lbx, lby, lbz) int32 light bins, broadcastable to (F, H, W):
        one per frame for a point light, one per pixel for a directional
        light (``ops/shadow_dir.pixel_light_bins``).
      start_ent: (F, H, W) int32 originating entity (self-shadow skip).
      origin: (ox, oy, oz) float32 (F, H, W) world positions.
      inv_dir: (ix, iy, iz) float32 (F, H, W) reciprocal ray directions.
      work: when given, ``work["slab_tests"]`` is set to the number of slab
        tests the function needs on these inputs, for a bound on the
        kernel's time: each ray's tests at its first probe of each bin (a
        repeated probe tests the same boxes again), up to its first
        occluder in the reference's order (a 0-d int64 tensor).
        ``work["slab_tests_every_probe"]`` counts the tests at every probe,
        repeats included, and ``work["slab_tests_finite"]`` the needed
        tests of rays whose reciprocal direction is finite on every axis.
      max_steps: a ray probes ``7 * min(int(largest), max_steps)`` phases;
        ``None`` for no cap.  The JAX package's ``shadow.trace_light`` with
        its static ``max_steps`` (a scan of ``7 * max_steps`` phases, rays
        active while ``t < 7 * n_steps``) is this function with the cap.
      live: (F, H, W) bool, the rays to march, or ``None`` for all: a ray
        outside it tests nothing, counts no test and reads False.
    """
    cfg = config
    cap = cfg.bin_capacity
    f32 = torch.float32
    dev = bins_ent.device
    F = bins_ent.shape[0]

    rbx = start_bin[0]
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

    first = (_first_probes(start_bin, end_bin, rbx.shape, cfg, max_steps)
             if work is not None else None)
    occluded = (torch.zeros(rbx.shape, dtype=torch.bool, device=dev)
                if live is None else ~live)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    every_probe = torch.zeros((), dtype=torch.int64, device=dev)
    finite_tests = torch.zeros((), dtype=torch.int64, device=dev)
    finite = (torch.isfinite(ivx) & torch.isfinite(ivy)
              & torch.isfinite(ivz))
    for t, (flat, probe) in enumerate(dda_probes(start_bin, end_bin, cfg,
                                                 max_steps)):
        test = probe & ~occluded
        if not bool(test.any()):
            # No ray probes a bin this phase (all done, or outside the grid
            # as rays toward a far light mostly are): nothing to test.
            continue

        flat_c = torch.where(probe, flat, 0).long()
        cnt = counts[frame, flat_c]
        first_t = first(t) if first is not None else None
        for k in range(cap):
            ent = bins_ent[frame, flat_c, k]
            consider = test & (k < cnt) & (ent != start_ent)
            if first_t is not None:
                live = consider & ~occluded
                every_probe += live.sum()
                tests += (live & first_t).sum()
                finite_tests += (live & first_t & finite).sum()
            occluded = occluded | (consider
                                   & slab_hit(torch.where(ent >= 0, ent, 0)))
    if work is not None:
        work["slab_tests"] = tests
        work["slab_tests_every_probe"] = every_probe
        work["slab_tests_finite"] = finite_tests
    return ~occluded
