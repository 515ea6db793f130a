"""Tensor-parallel analog: shard the ENTITY LIST across the ranks.

Counterpart of ``pixel_art_raytracer_tpu/parallel/entity_sharded.py``.
Every rank bins and traces only its entity shard (``csrc/trace.cu`` on the
shard's tables), then the partial per-pixel winners merge by depth key with
two collectives: ``all_reduce(MAX)`` of the depth key, then
``all_reduce(MIN)`` of the global entity id among the ranks tied at that
depth.  The depth key is the trace kernel's best-depth output
(``trace_cuda.trace_winners(with_best=True)``), the key the walk compared,
not one decoded again from the winner.  The winning rank materialises its
pixels' G-buffer and an ``all_reduce(SUM)`` assembles it (the others
contribute zeros); every rank marches its own entities with the point mode
of ``csrc/shadow.cu`` under local ids, and an ``all_reduce(MAX)`` ORs the
occlusion.

Exactness caveat (as in the JAX package): the reference keeps the FIRST
candidate in global bin (bin_z, slot) order (alternative.cpp:344-346), and
slot order follows global insertion order, wrap-at-8 overwrite included
(quirk Q3).  The sharded render is pixel-identical to the unsharded one
when (a) no bin overflows its capacity and (b) ``early_exit`` is off: the
exit counter (quirk Q5) would see only a shard's occupancy.
:func:`envelope_ok` checks both on the host before a render, which raises
outside them; the replicated paths (``parallel/mesh.py``) stay exact on
every scene.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..ops import binning, shade, shadow_cuda, trace, trace_cuda
from ..ops.trace import INT32_MIN, GBufferArrays
from .mesh import Mesh, group_mesh

INT32_MAX = torch.iinfo(torch.int32).max

entity_axis = "entities"


def make_entity_mesh(n_devices: int | None = None, group=None) -> Mesh:
    """A one-axis (entities) mesh over the ranks of ``group``."""
    n = n_devices or dist.get_world_size(group)
    return group_mesh(n_devices, (entity_axis,), (n,), group)


def envelope_ok(pos, ext, config: RenderConfig) -> tuple[bool, str]:
    """Host-side static check of the exactness envelope (module docstring):
    ``early_exit`` off, and no bin's insertion total over the capacity.
    ``pos``, ``ext``: (N, 3) numpy.  Returns ``(ok, reason)``, the JAX
    package's reasons; reason is "" when ok."""
    if config.early_exit:
        return False, ("early_exit is on: per-shard exit counters diverge "
                       "from the reference's global bin scan")
    totals = binning.bin_totals_numpy(pos, ext, config)
    if int(totals.max()) > config.bin_capacity:
        return False, (f"bin overflow (max {int(totals.max())} insertions > "
                       f"capacity {config.bin_capacity}): wrap-at-capacity "
                       "slot survival depends on global insertion ranks")
    return True, ""


def _sum(x: torch.Tensor, keep: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``x`` where ``keep``, zeros elsewhere."""
    out = torch.where(keep, x, torch.zeros_like(x))
    dist.all_reduce(out, dist.ReduceOp.SUM, group=mesh.group)
    return out


def render_frame_entity_sharded(renderer, dscene, light, mesh: Mesh,
                                unchecked: bool = False) -> torch.Tensor:
    """Render one frame with the scene's entities sharded over ``mesh``.

    Every rank passes the same ``dscene`` and point light ``light``
    (x, y, z) and touches only its block of entities; the entity count must
    divide the mesh size (pad the scene with culled boxes otherwise).
    Returns the (H, W, 3) uint8 frame on every rank.

    The exactness envelope is checked first (:func:`envelope_ok`): scenes
    outside it raise ``ValueError``; ``unchecked=True`` skips the check for
    callers that accept the documented divergence.
    """
    cfg: RenderConfig = renderer.config
    if not unchecked:
        ok, reason = envelope_ok(dscene.pos.cpu().numpy(),
                                 dscene.ext.cpu().numpy(), cfg)
        if not ok:
            raise ValueError(
                "entity-sharded rendering would silently diverge from the "
                f"reference on this scene: {reason}. Render with the "
                "replicated frame/row sharding (parallel/mesh.py), or pass "
                "unchecked=True to accept the divergence.")
    n_shards = mesh.shape[entity_axis]
    N = dscene.pos.shape[0]
    if N % n_shards:
        raise ValueError(f"{N} entities do not divide the mesh of "
                         f"{n_shards}")
    Np = N // n_shards
    offset = mesh.coords()[entity_axis] * Np
    shard = slice(offset, offset + Np)
    pos_l, ext_l, sid_l = (t[shard] for t in (dscene.pos, dscene.ext,
                                              dscene.sprite_id))
    # Local entity 0 takes its own position: the kernels read entity 0's
    # from ``players``.
    players = pos_l[:1]

    # Local bins and the shard's winners with their depth keys.
    be, cnt = binning.build_bins(pos_l, ext_l, cfg, renderer.spans)
    be, cnt = be[None], cnt[None]
    best, winner_l = trace_cuda.trace_winners(
        pos_l, ext_l, sid_l, dscene.atlas_depth, be, cnt, players, cfg,
        with_best=True)

    # Greatest depth wins; depth ties keep the lowest global entity id.
    gwin = torch.where(winner_l >= 0, winner_l + offset, INT32_MAX)
    dmax = best.clone()
    dist.all_reduce(dmax, dist.ReduceOp.MAX, group=mesh.group)
    gw = torch.where((best == dmax) & (gwin < INT32_MAX), gwin, INT32_MAX)
    dist.all_reduce(gw, dist.ReduceOp.MIN, group=mesh.group)
    hit = (dmax > INT32_MIN) & (gw < INT32_MAX)
    mine = hit & (gw >= offset) & (gw < offset + Np)

    # The winning rank's G-buffer attributes, assembled by a sum.
    gbuf_l = trace.materialize_gbuffer(
        torch.where(mine, gw - offset, -1), pos_l, ext_l, sid_l,
        dscene.atlas_color, dscene.atlas_depth, dscene.atlas_normal,
        dscene.palette, players, cfg)
    normal = _sum(gbuf_l.normal, mine[..., None], mesh)
    color_i = _sum(gbuf_l.color.to(torch.int32), mine[..., None], mesh)
    bg = torch.tensor(cfg.background, dtype=torch.int32,
                      device=color_i.device)
    color = torch.where(hit[..., None], color_i, bg).to(torch.uint8)
    gbuf = GBufferArrays(normal=normal, color=color,
                         y=_sum(gbuf_l.y, mine, mesh),
                         z=_sum(gbuf_l.z, mine, mesh),
                         entity_index=torch.where(hit, gw, 0))

    # Shadow: every rank marches its own entities; occlusion ORs.  The
    # self-shadow skip takes LOCAL ids: another shard's pixels map outside
    # [0, Np) and never match a local candidate.
    lights = torch.as_tensor(light, dtype=torch.int32,
                             device=dscene.device)[None]
    tl, inv, origin, rb, lb = shade.light_geometry(gbuf, lights, cfg)
    lit_l = shadow_cuda.trace_light(pos_l, ext_l, be, cnt, rb, lb,
                                    gbuf.entity_index - offset, origin, inv,
                                    players, cfg)
    occluded = (~lit_l).to(torch.int32)
    dist.all_reduce(occluded, dist.ReduceOp.MAX, group=mesh.group)
    factor = shade.factor_from_dot(shade.lambert_dot(gbuf.normal, tl),
                                   occluded == 0, cfg)
    return shade.shade_u8(gbuf.color, factor)[0]
