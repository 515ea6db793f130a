"""Frame x row sharded rendering and the data-parallel training step over
``torch.distributed``.

Counterpart of ``pixel_art_raytracer_tpu/parallel/mesh.py``.  One process
per rank; where the JAX package takes a ``jax.sharding.Mesh``, the port
takes a :class:`Mesh`, a layout of the ranks of a process group on named
axes.

* **frame axis** ("data parallel"): the frames of a batch are independent,
  so each rank renders its own block of them.
* **row axis** ("spatial parallel"): given the replicated bin tables every
  pixel row is independent, so each rank traces, marches and shades its own
  window of whole bin rows only (``trace.cu`` and the point mode of
  ``shadow.cu`` launch over that window's bin rows), as the JAX package's
  shard_map path does (its row blocks must sit inside bin rows too).
* Scene arrays and bin tables are replicated: every rank holds all of them.
* The training step (inverse rendering) is classic data parallelism: each
  rank's sum of squared error and its gradient over its frames and rows,
  ``all_reduce(SUM)`` of both, divided by the global element count (the
  psum XLA inserts), then the same Adam step on every rank, so the light
  stays replicated.

The JAX package's two render functions compute the same frames (GSPMD or
shard_map around the Pallas kernels); here they are one body, and
:func:`render_frames_shardmap` is a name for :func:`render_frames_sharded`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models import batched
from ..ops import trace

frame_axis = "frames"
row_axis = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of process group ``group`` (None: the default group) laid
    out on named axes, rank-major: a rank's coordinate on the last axis
    varies fastest."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def coords(self) -> dict[str, int]:
        """This process's coordinate on each axis."""
        rank = dist.get_rank(self.group)
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.axis_names}


def group_mesh(n_devices: int | None, axis_names: tuple[str, ...],
               sizes: tuple[int, ...], group=None) -> Mesh:
    """A :class:`Mesh` of ``sizes`` over the ranks of ``group``; raises
    ``ValueError`` unless it has exactly ``n_devices`` ranks (None: any)."""
    n_ranks = dist.get_world_size(group)
    n = n_devices or n_ranks
    if n != n_ranks:
        raise ValueError(
            f"a mesh of {n} devices: the process group has "
            f"{'only ' if n > n_ranks else ''}{n_ranks} ranks; start one "
            f"process per device")
    return Mesh(axis_names, sizes, group)


def make_mesh(n_devices: int | None = None,
              frame_parallel: int | None = None, group=None) -> Mesh:
    """A (frames, rows) mesh over the ranks of ``group``.

    ``frame_parallel`` fixes the frame-axis size; by default the mesh is
    split as evenly as possible (frames-major), as in the JAX package.
    ``n_devices``, when given, must equal the group's size.
    """
    n = n_devices or dist.get_world_size(group)
    if frame_parallel is None:
        frame_parallel = next(c for c in range(math.isqrt(n), 0, -1)
                              if n % c == 0)
    if n % frame_parallel:
        raise ValueError(f"frame_parallel {frame_parallel} does not divide "
                         f"{n} devices")
    return group_mesh(n_devices, (frame_axis, row_axis),
                      (frame_parallel, n // frame_parallel), group)


def local_block(mesh: Mesh, n_frames: int, config):
    """This rank's part of a batch of ``n_frames`` frames: ``(frames,
    rows)``, the slice of its frames and its window of pixel rows (None
    for the whole view on a mesh of one row shard).  Raises ``ValueError``
    unless the frames divide the frame axis and each row shard is whole bin
    rows (``trace.row_window``)."""
    fp, rp = mesh.shape[frame_axis], mesh.shape[row_axis]
    at = mesh.coords()
    if n_frames % fp:
        raise ValueError(f"{n_frames} frames do not divide the frame axis "
                         f"of {fp}")
    per = n_frames // fp
    frames = slice(at[frame_axis] * per, (at[frame_axis] + 1) * per)
    if rp == 1:
        return frames, None
    H = config.view_height
    if H % rp:
        raise ValueError(f"{H} rows do not divide the row axis of {rp}")
    n_rows = H // rp
    rows = (at[row_axis] * n_rows, n_rows)
    trace.row_window(config, rows)
    return frames, rows


def render_frames_sharded(anim_renderer, dscene, player_pos, lights,
                          mesh: Mesh) -> torch.Tensor:
    """Render an animation batch sharded over (frames, rows).

    player_pos, lights: the whole batch's (F, 3) int32 (or (F, L, 3)
    multi-light) states, the same on every rank, with F divisible by the
    frame axis; each row shard is whole bin rows.  Each rank renders its
    frames' row window through ``batched.gbuffer_and_frames`` (on the
    renderer's two-kernel path when the window is not the whole view), then
    an ``all_reduce(SUM)`` assembles the frames, each element from the one
    rank that rendered it.  Returns the (F, H, W, 3) uint8 frames on every
    rank.
    """
    cfg = anim_renderer.config
    batched.check_supported(lights, False, None)
    frames, rows = local_block(mesh, player_pos.shape[0], cfg)
    local = batched.gbuffer_and_frames(
        anim_renderer.renderer, anim_renderer.static_bins, dscene,
        player_pos[frames], lights[frames], rows=rows)[1]
    row0, n_rows = trace.row_window(cfg, rows)
    out = torch.zeros((player_pos.shape[0], cfg.view_height,
                       cfg.view_width, 3), dtype=torch.uint8,
                      device=local.device)
    out[frames, row0:row0 + n_rows] = local
    dist.all_reduce(out, dist.ReduceOp.SUM, group=mesh.group)
    return out


# The JAX package's shard_map path around its Pallas kernels renders the
# same frames as its GSPMD path; the port's one body serves both names.
render_frames_shardmap = render_frames_sharded


def sharded_train_step(fitter, light, opt_state, dscene, targets,
                       mesh: Mesh):
    """One data-parallel inverse-rendering step over a sharded batch.

    targets: the whole batch's (F, H, W, 3) float32 targets, the same on
    every rank, F divisible by the frame axis and each row shard whole bin
    rows.  Each rank renders its row window (``soft_frame(rows=)``) and
    takes the sum of squared error over its frames and rows and its
    gradient; ``all_reduce(SUM)`` of both, divided by the batch's element
    count, gives the loss and gradient of ``fitter.train_step``, and every
    rank applies the same Adam step.  Returns ``(light, opt_state, loss)``
    as ``train_step`` does.
    """
    frames, rows = local_block(mesh, targets.shape[0], fitter.config)
    row0, n_rows = trace.row_window(fitter.config, rows)
    opt_state.zero_grad(set_to_none=True)
    pred = fitter.soft_frame(dscene, light, rows=rows)
    local = targets[frames, row0:row0 + n_rows]
    sse = torch.sum((pred[None] - local) ** 2)
    sse.backward()
    total = torch.cat([sse.detach().reshape(1), light.grad])
    dist.all_reduce(total, dist.ReduceOp.SUM, group=mesh.group)
    total = total / torch.tensor(float(targets.numel()), dtype=total.dtype,
                                 device=total.device)
    light.grad.copy_(total[1:])
    opt_state.step()
    return light, opt_state, total[0]
