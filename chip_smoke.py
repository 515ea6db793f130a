#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``pixel_art_raytracer_tpu_torch/csrc``
(one nvcc per source, in parallel) and the C++ oracle, renders the graybox
world (480x320, 162,308 boxes) through ``AnimationRenderer.render_states``
for the three light orbits of ``bench.py`` (F = 64 frames each), once on the
two-kernel path (``trace.cu``'s winners, then the winner-input point mode
of ``shadow.cu``, which derives each pixel's surface and shadow ray from
its winner and writes the shaded frame) and once with
``fuse_trace_shadow`` (the fused kernel), and fails (exit code != 0)
unless:

  * each kernel (trace, the G-buffer and the winner-input point modes of
    shadow, fused) equals its plain PyTorch version bit for bit on the
    card, on all 64 frames of every orbit (the main paths' shapes): the
    winner-input mode's frames equal ``shade.point_frames`` (and the
    G-buffer chain's frames), its lit mask the march's;
  * the two-kernel run launched exactly trace 1 + the winner-input mode 1
    a batch and called none of the G-buffer chain's functions
    (``materialize_gbuffer``, ``light_geometry``, ``lambert_dot``,
    ``factor_from_dot``, ``shade_u8``), and the fused counter rose during
    the fused run;
  * the shadow and fused kernels' list path (one DDA per start bin of a
    tile, csrc/common.cuh march_tile) took pixels on every orbit and on
    both main paths, beside the pixels they marched directly;
  * the fused path's frames equal the two-kernel path's bit for bit;
  * both paths' frames equal ``runtime.native.cpp_render_frame`` pixel for
    pixel (frame 0 of every orbit and one mid-sweep frame of ``edge_z``).

Then it renders the lighting modes at the same size (F = 64): directional
lights (a sweep of 64 directions (cos t, 1, 0.5 sin t) with the player at
home), additive multi-light (the three orbits' lights as (64, 3, 3)), and
the dithered style (the center orbit with a point light on both paths, and
the directional sweep dithered: BASELINE config 4's pair), and fails
unless:

  * the shadow kernel's directional mode equals its plain version
    (``ops/shadow_dir.trace_light_directional``, the capped march with
    per-pixel light bins) bit for bit on all 64 frames, its list path took
    pixels, fewer than 1% of them took the direct march, its longest
    visit list and the union entries it staged (each tile's distinct bins
    of its (start bin, light bin) keys' visit lists under the cap) equal
    the CPU's count (``ops/shadow_dir.tile_unions``), which is below the
    per-key lists' entries;
  * each batch launches exactly: multi-light trace 1, shadow 3, fused 0 on
    both settings of ``fuse_trace_shadow``; directional trace 1 and the
    directional mode 1, fused 0, on both; dithered with a point light the
    fused kernel once with ``fuse_trace_shadow`` and trace 1 + shadow 1
    without;
  * frames 0 and 32 of every new path equal the same states rendered on the
    CPU through the plain versions, the dithered frames hold palette
    colours only, and the dithered two-kernel and fused frames are equal.

Last, BASELINE config 5 (10,000 boxes on a 1024x1024 base view, as
``tools/bench_scale.py`` builds it) supersampled at s = 2 and 4: a light
sweep of F = 8 frames through ``render_states`` on the renderer of
``SupersampledRenderer`` (2048**2 and 4096**2 pixels, bins of 80 and 160
pixels, walked in row bands by the trace and fused kernels) on both paths.
It fails unless the launch counts of each batch are exact (trace 1 + the
winner-input mode 1, or fused 1), the kernels equal their plain versions
(all 8 frames at s = 2, frames 0 and 4 at s = 4), both paths' frames are
equal, frame 0 equals ``cpp_render_frame`` on the scaled scene,
``SupersampledRenderer.render`` of frame 0 (the main path at F = 1)
equals that oracle frame box-filtered to 1024x1024, and
``render_with_gbuffer`` of frame 0's state (trace 1 + the G-buffer mode 1)
equals the oracle frame.  Then one frame of the same scene generator on a
2048x2048 view at bin 40 (52 x 52 x 8 = 21,632 bins, a grid whose visit
lists the winner-input mode once refused) through ``render_states``
(trace 1 + the winner-input mode 1): both kernels equal their plain
versions and frame 0 equals ``cpp_render_frame``.

Then the binning kernel (``csrc/binning.cu``, the full rebin) on graybox
(F = 1), config 5 at s = 2, that 21,632-bin grid (three count tiles) and a
64,000-bin grid (eight): its tables equal the plain version's
(``binning.plain_tables`` on the card) and ``cpp_build_bins``', its
static-cache layout the plain version's, and on graybox with ``players``
as the live frame passes them (F = 1, and F = 4 distinct), with its time,
the plain version's and its bound.

Then the port's run entry points, each driven with the launch counts set
to 0 just before it and read just after (every ``StaticBins`` cache built
there and every full rebin is the binning kernel's 2 launches):

  * ``bench.run`` (``python -m pixel_art_raytracer_tpu_torch.bench``) on
    graybox at F = 64, 3 repeats, no settle-wait: center frame 0 of both
    paths' timed output equal to ``cpp_render_frame``, and exactly trace 1
    + the winner-input mode 1 a batch on the two-kernel path and fused 1 on
    the fused path, binning 2 for the cache; its JSON line printed;
  * ``bench_scale.run`` on config 5 with ``--nonramp``'s atlas (half the
    boxes with a depth map that varies along a row) at s = 2 and 4: frame 0
    of both paths equal to ``cpp_render_frame``, ``render`` to its box
    filter, exact launches (binning 2 for the cache and each single
    frame), and the three kernels equal to their plain
    versions on frame 0; its JSON lines printed;
  * ``make_demo``'s 32-frame sweep (trace 1 + the winner-input mode 1,
    binning 2 for its cache):
    the GIF and the PNG byte-equal to ``docs/graybox_sweep.gif`` and
    ``docs/graybox_frame.png``.

Then the entry points a user of the renderer meets outside a batch, each
path driven with the launch counts set to 0 just before it and read just
after, its kernels held to their plain versions on one batch of its
inputs:

  * ``BruteForceRenderer`` on BASELINE config 1 (two boxes, 64x64): its
    entity index equals ``cpp_trace_pixels``', its unshadowed frame the
    CPU's, its ``shadow=True`` frame (shadow 1, binning 2)
    ``cpp_render_frame``;
    then its trace of graybox at full width, timed, with the pixels whose
    winner differs from the deferred path's printed (graybox's bins
    overflow, so they may);
  * ``Session`` on graybox: a 24-frame script of every binding and cursor
    moves (trace 1 + shadow 1 + binning 2 a frame), frames 0, 12 and 23
    equal to
    ``cpp_render_frame`` with the red line drawn at endpoints from
    ``cpp_trace_pixels``' y and z, the mouse readouts, ``debug_report()``
    (from ``cpp_build_bins``' counts) and ``normal_view()`` (from the
    oracle's normals) equal, ``save_gif`` on the native encoder; then 8
    frames with ``fuse_trace_shadow`` (fused 1 + binning 2 a frame) equal
    to the
    two-kernel session's;
  * ``LiveViewer`` on graybox through the viewer's --bench loop, 100
    frames (trace 1 + shadow 1 + binning 2 a frame), frame 0 held as
    above; the loop's
    median ms/frame and the render + overlay share;
  * BASELINE config 2 (the 101-box overlap scene at 256x256): a 32-frame
    light sweep through ``render_long`` in chunks of 8 (trace 4 + the
    winner-input mode 4 + binning 8: no cache there), then again after the
    last chunk's file is deleted (trace 1 + the winner-input mode 1 +
    binning 2, the same frames), frames 0
    and 31 equal to ``cpp_render_frame``, ``render_with_gbuffer`` of frame
    0's state equal to frame 0, the GIF written by the native encoder;
    ms/frame and Mrays/s.

Last, the inverse fitter and the sharded paths (``inverse_phase``,
``parallel_phase``):

  * ``InverseLightFitter`` on graybox, 25 Adam steps at lr 2.0 toward the
    center orbit's first 8 frames (/ 255 by a tensor): with shadows from
    (20, 20, 40) (every lit pixel there has no Lambert gain: the gradient
    is exactly 0 and the light stays, which the phase checks), with
    shadows from (400, 120, 60), and without shadows from (20, 20, 40);
    exact launches (trace 1, binning 2, and shadow 1 with shadows, a
    step); the loss
    decreasing; ``soft_frame`` and the gradient with the kernels equal to
    the same with the plain versions on the card at the start and the
    fitted light; ``trace.cu`` and the point mode of ``shadow.cu`` under
    the step cap of 16 equal to their plain versions on a step's inputs;
    ``1 / t`` at t == 0 equal to the CPU's, infinities signed;
  * ``parallel/`` over 2 ranks that share the card over gloo: the frame x
    row render of 8 frames on (frames 2, rows 1) and (frames 1, rows 2),
    one ``sharded_train_step`` on both, the entity-sharded render of
    ``demo_world(24)`` (early_exit off); every rank's result equal to the
    single process's, trace 1 + shadow 1 launches a rank in each run
    (and binning 2 in the train step and the entity-sharded render); the
    windowed and shard kernels equal to their plain versions on the
    ranks' inputs; ms per call (a functional check on one card, not a
    scaling measurement).

It prints the card, the build times, the three kernels' shared memory per
block and blocks per SM, per orbit each march kernel's counters (pixels
marched directly, the most start bins one tile held, the longest visit
list), ms/frame, Mrays/s and the per-stage split of both paths, the
kernels' times beside their plain versions and their bounds, the same
for the new paths (Mrays/s counting 1 + L rays a pixel) and the
directional mode (with its counters, the union entries staged and the slab
tests performed beside the plain version's count, its shared memory,
blocks per SM and registers),
for the winner-input mode on graybox, config 5, the 21,632-bin grid and
config 2 its bands, chunk, launch grid, shared memory and blocks per SM,
for config 5 the bands, the kernels' shared memory, blocks per SM, times,
plain times, bounds and counters, peak memory and ms/frame, the new
paths' times, a JSON line on the kernels (a row for each kernel on each
path) and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with an
error before printing any result.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s, and the operations these inputs need over
67 T/s (the H100 SXM's float32 rate outside the tensor cores, taken for
its integer operations too, so the bound stays a lower bound).  The
operations are counted from this run's data by the plain versions: 9
integer operations per candidate hit test of the trace walk, 23 float
operations per slab test of the shadow march (each ray tests a bin's boxes
at its first probe of the bin only, and stops at its first occluder), and
for the winner-input mode 29 float operations a pixel besides (its ray,
dot, factor and colour: ``SHADE_OPS``).  It
also prints the bounds of two other counts: the walk's depth keys alone,
15 integer operations per candidate that passes the hit test (what a pixel
needs at least), and the march's slab tests at every probe, repeats
included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, Light,
                                           RenderConfig, SceneBuilder,
                                           bench, bench_scale,
                                           default_light, demo_world,
                                           graybox_world, make_demo)
from pixel_art_raytracer_tpu_torch.bench_scale import config5_scene
from pixel_art_raytracer_tpu_torch.device import card as card_line
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import (
    KEY_BINDINGS, AnimationRenderer, scene_with_player)
from pixel_art_raytracer_tpu_torch.models.brute import (SHADOW_SPANS,
                                                        BruteForceRenderer)
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.inverse import InverseLightFitter
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer, box_filter, scale_scene, scaled_config)
from pixel_art_raytracer_tpu_torch.ops import (binning, binning_cuda, fused,
                                               fused_cuda, shade, shadow,
                                               shadow_cuda, shadow_dir, trace,
                                               trace_cuda)
from pixel_art_raytracer_tpu_torch.ops.cstyle import normal_to_debug_color
from pixel_art_raytracer_tpu_torch.ops.overlay import draw_line_host
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.ops.trace import GBufferArrays
from pixel_art_raytracer_tpu_torch.parallel import (
    make_entity_mesh, make_mesh, render_frame_entity_sharded,
    render_frames_sharded, sharded_train_step)
from pixel_art_raytracer_tpu_torch.parallel.launch import run_ranks
from pixel_art_raytracer_tpu_torch.runtime import kernels, native
from pixel_art_raytracer_tpu_torch.runtime.session import Session
from pixel_art_raytracer_tpu_torch.runtime.viewer import (LiveViewer,
                                                         ansi_frame,
                                                         bench_loop)
from pixel_art_raytracer_tpu_torch.utils.gif import write_gif
from pixel_art_raytracer_tpu_torch.utils.metrics import RenderStats

FRAMES = 64
TIMED_REPS = 5
KERNEL_REPS = 20
PLAIN_REPS = 1

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
TRACE_OPS_PER_CANDIDATE = 9
# The depth key of a hit: the row, ey - row and its min with 0, the clamped
# texel row and column, the texel address, the key and its compare.
DEPTH_KEY_OPS = 15
# A slab test: 6 subtractions, 6 multiplies, 10 min/max and a compare.  Where
# the reciprocal direction is finite on every axis and shared by all the
# rays of a frame (a directional light), each staged box's near corner on
# each axis is known once per box, and the test takes 6 subtractions, 6
# multiplies, 2 max, 2 min and a compare.  Point-light rays each have their
# own direction, so their tests order the corners themselves: 23.
SLAB_OPS = 23
NEAR_FAR_OPS = 17
# The float operations of a pixel of the winner-input point mode besides
# its slab tests (its integer decode of the winner not counted): the ray's
# 3 subtractions, 3 absolute values, 2 additions and 6 divisions, the
# Lambert dot's 3 multiplies and 2 additions, the factor's 2 compares, 1
# addition and 1 select, and the colour's 3 multiplies and 3 truncations.
SHADE_OPS = 29

SOURCES = {
    "trace": ("pixel_art_raytracer_tpu_torch/csrc/trace.cu",
              "pixel_art_raytracer_tpu/ops/trace_pallas.py:467"),
    "shadow": ("pixel_art_raytracer_tpu_torch/csrc/shadow.cu",
               "pixel_art_raytracer_tpu/ops/shadow_pallas.py:626"),
    # The winner-input point mode of shadow.cu: the JAX kernel's
    # winner-direct inputs and shade epilogue.
    "shadow_shade": ("pixel_art_raytracer_tpu_torch/csrc/shadow.cu",
                     "pixel_art_raytracer_tpu/ops/shadow_pallas.py:626"),
    "fused": ("pixel_art_raytracer_tpu_torch/csrc/fused.cu",
              "pixel_art_raytracer_tpu/ops/fused_pallas.py:105"),
}
# The directional mode of csrc/shadow.cu replaces _shadow_kernel as the JAX
# batched path launches it on its extended tables (models/batched.py:821).
DIRECTIONAL_SOURCE = ("pixel_art_raytracer_tpu_torch/csrc/shadow.cu",
                      "pixel_art_raytracer_tpu/ops/shadow_pallas.py:626")
# Most of a directional sweep's pixels that may take the direct march.
DIRECT_SHARE = 0.01
DIRECTIONAL_KEY_LABEL = "(start bin, light bin) keys"

# BASELINE config 5 (BASELINE.json:11), as tools/bench_scale.py:37-72
# builds it (``bench_scale.config5_scene``): a 1024 x 1024 base view,
# 10,000 boxes, rendered at s = 2 and 4 (2048**2 and 4096**2) in batches of
# F = 8 (bench_scale's default; a batch of 8 peaks at ~16 GiB at 4096**2,
# so BASELINE.json's 64 frames would not fit in the H100's 80 GB).  The
# kernels are held to their plain versions on all frames at s = 2 and on
# frames 0 and 4 at s = 4: the plain versions take ~7 s a call for 33.5 M
# pixels.
CONFIG5 = bench_scale.CONFIG
CONFIG5_FRAMES = bench_scale.FRAMES
CONFIG5_LIGHT = bench_scale.LIGHT
CONFIG5_CHECKED = {2: list(range(CONFIG5_FRAMES)), 4: [0, 4]}
# The port's run entry points: ``bench.run`` on graybox at F = 64 with 3
# repeats and no settle-wait, ``bench_scale.run`` on config 5 with the
# non-ramp atlas at s = 2 and 4 (3 iterations, F = 8; the kernels held to
# their plain versions on frame 0), ``make_demo``'s 32-frame sweep.
BENCH_REPEATS = 3
BENCH_SCALE_ITERS = 3
# A grid the winner-input mode used to refuse (its visit lists needed
# 377,520 B of shared memory): config 5's scene generator on a 2048**2 view
# at bin 40, 52 x 52 x 8 = 21,632 bins, one frame under config 5's light.
WIDE_GRID = RenderConfig(view_width=2048, view_height=2048, view_length=320)

# BASELINE config 1 (BASELINE.json configs[0], tests/test_configs.py:
# 94-121): two reference boxes on a 64 x 64 frame, for the brute renderer.
CONFIG1 = RenderConfig(view_width=64, view_height=64, view_length=64)
CONFIG1_LIGHT = Light(64, 32, 16)
BRUTE_REPS = 2
# The interactive runtime on graybox: a Session script of 24 frames (8 of
# them again with fuse_trace_shadow), frames 0, 12 and 23 held to the
# oracle, and the viewer's --bench loop of 100 frames.
SESSION_FRAMES = 24
SESSION_FUSED_FRAMES = 8
SESSION_CHECKED = (0, 12, 23)
VIEWER_FRAMES = 100
# BASELINE config 2 (configs[1], tests/test_configs.py:19-31, 58-72): the
# 101-box overlap scene at 256 x 256, a 32-frame light sweep through
# render_long in chunks of 8, to a GIF.
CONFIG2 = RenderConfig(view_width=256, view_height=256, view_length=320)
CONFIG2_FRAMES = 32
CONFIG2_CHUNK = 8
# The inverse fitter (models/inverse.py) on graybox: the targets are the
# uint8 frames of the center orbit's first 8 states divided by 255 (by a
# tensor), fitted from (20, 20, 40) by 25 Adam steps at lr 2.0, with and
# without shadows (the shadow march capped at the renderer's
# shadow_max_steps, 16).
INVERSE_TARGETS = 8
INVERSE_STEPS = 25
INVERSE_LR = 2.0
INVERSE_START = (20.0, 20.0, 40.0)
# With shadows, 99.3% of graybox's pixels are in shadow from (20, 20, 40)
# and every lit one has no Lambert gain, so the gradient there is exactly 0
# and Adam cannot move (measured on the card and the CPU alike): the
# shadowed fit also runs from (400, 120, 60), where 0.83 of them are lit.
INVERSE_LIT_START = (400.0, 120.0, 60.0)
INVERSE_RUNS = (("with shadows", True, INVERSE_START),
                ("with shadows, from a lit start", True, INVERSE_LIT_START),
                ("without shadows", False, INVERSE_START))
# The sharded paths (parallel/) over 2 ranks that share the one card over
# gloo (NCCL refuses two ranks on one device): a functional check, not a
# scaling measurement.  F = 8 states of the center orbit, meshes of
# (frames 2, rows 1) and (frames 1, rows 2); ms per call over 3 calls.
PARALLEL_RANKS = 2
PARALLEL_FRAMES = 8
PARALLEL_REPS = 3
MESHES = {"frames 2 x rows 1": 2, "frames 1 x rows 2": 1}
# The entity-sharded render's scene: demo_world(24) at graybox's 480 x 320
# with early_exit off, the largest of the repo's scenes that envelope_ok
# accepts (graybox's bins take up to 14 insertions and config 5's up to
# 112, over the capacity of 8; demo_world lays 20-cubes on a 20-pixel
# grid, and 24 a side covers the view's width), with one culled box
# appended so its 578 entities divide 2 ranks.
ENTITY_SIDE = 24


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card: one warm-up call unless
    the caller has just made one, then ``reps`` calls between two CUDA
    events."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_split(stages, reps: int,
                frames: int = FRAMES) -> dict[str, float]:
    """ms/frame of each ``(name, fn)`` stage of a batch of ``frames``, run
    in order with CUDA events between them; each ``fn(state)`` reads and
    writes the dict ``state``.  One warm-up pass, then the mean of
    ``reps``."""
    total = {name: 0.0 for name, _ in stages}
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 1)]
    for rep in range(reps + 1):
        state = {}
        torch.cuda.synchronize()
        events[0].record()
        for k, (_, fn) in enumerate(stages):
            fn(state)
            events[k + 1].record()
        torch.cuda.synchronize()
        if rep:
            for k, (name, _) in enumerate(stages):
                total[name] += (events[k].elapsed_time(events[k + 1])
                                / reps / frames)
    return total


def main_path_stages(r, cache, ds, players, lights):
    """The two-kernel main path's stages of one batch, as ``(name, fn)``
    pairs for :func:`stage_split`: bins (``cache`` or a full rebuild when
    None), trace (the winners), shadow + shade (the winner-input point mode
    of shadow.cu, frames out)."""

    def bins(st):
        st["be"], st["cnt"] = batched.bin_stage(r, cache, ds, players)

    def winners(st):
        st["win"] = batched.winner_stage(r, ds, st["be"], st["cnt"], players)

    def shade_frames(st):
        st["frames"] = batched.shade_point_stage(r, ds, st["be"], st["cnt"],
                                                 players, st["win"], lights)

    return [("bins", bins), ("trace", winners),
            ("shadow+shade", shade_frames)]


def gbuffer_stages(r, cache, ds, players, lights):
    """The G-buffer mode's stages of one batch (the main path before the
    winner-input mode; the other lighting modes' shape), as ``(name, fn)``
    pairs for :func:`stage_split`: bins, trace + G-buffer, geometry,
    shadow, shade."""

    def bins(st):
        st["be"], st["cnt"] = batched.bin_stage(r, cache, ds, players)

    def trace_gbuf(st):
        st["gbuf"] = batched.trace_stage(r, ds, st["be"], st["cnt"], players)

    def geometry(st):
        st["dot"], *st["rays"] = batched.geometry_stage(r, st["gbuf"],
                                                        lights)

    def shadow_lit(st):
        st["lit"] = batched.shadow_stage(r, ds, st["be"], st["cnt"],
                                         players, st["gbuf"], *st["rays"])

    def shade_frames(st):
        st["frames"] = batched.shade_stage(r, ds, st["gbuf"],
                                           shade.factor_from_dot(
                                               st["dot"], st["lit"],
                                               r.config))

    return [("bins", bins), ("trace+gbuffer", trace_gbuf),
            ("geometry", geometry), ("shadow", shadow_lit),
            ("shade", shade_frames)]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def entity_bytes(bins_ent, counts, *tables) -> int:
    """Bytes of the rows of the per-entity ``tables`` that the live slots
    of ``bins_ent`` name: all that a kernel can read of them."""
    live = (torch.arange(bins_ent.shape[-1], device=bins_ent.device)
            < counts[..., None])
    n = torch.unique(bins_ent[live]).numel()
    return n * sum(t[0].numel() * t.element_size() for t in tables)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of a kernel's work."""
    t_bytes = float(n_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = float(n_ops) / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def list_path(name: str, what: str, c: dict, n_pix: int,
              longest: int | None = None, keys: str = "start bins") -> None:
    """Print a march kernel's counters ``c`` (``MarchCounters.read()``);
    raise unless its list path took some of the ``n_pix`` pixels it
    marched and, where ``longest`` is given, its longest visit list has
    that length.  ``keys`` names what its table holds."""
    print(f"{name} {what}: {n_pix - c['direct_pixels']} pixels on the list "
          f"path, {c['direct_pixels']} marched directly, at most "
          f"{c['max_starts']} {keys} in a tile, longest visit list "
          f"{c['max_list']} bins")
    if c["direct_pixels"] >= n_pix:
        raise RuntimeError(f"{name}: the {what}'s list path took no pixel")
    if longest is not None and c["max_list"] != longest:
        raise RuntimeError(f"{name}: the {what}'s longest visit list has "
                           f"{c['max_list']} bins, dda_visit_lists "
                           f"{longest}")


def longest_visit_list(start_bin, light_bin, config) -> int:
    """The longest of ``shadow.dda_visit_lists`` over the distinct (start
    bin, light bin) pairs of these rays: its first visits of a bin, counted
    by ``shadow.dda_first_visits``."""
    keys = torch.stack([t.expand(start_bin[0].shape).reshape(-1)
                        for t in (*start_bin, *light_bin)], dim=1)
    keys = torch.unique(keys, dim=0)
    _, first = shadow.dda_first_visits(tuple(keys[:, :3].unbind(1)),
                                       tuple(keys[:, 3:].unbind(1)), config)
    return int(first.sum(0).max())


def directional_unions(c: dict, unions: dict, work: dict) -> None:
    """Print the directional mode's staged union entries and slab tests
    performed (``MarchCounters.read()`` ``c``) beside the CPU's count of
    the tiles' unions (``shadow_dir.tile_unions``) and the plain version's
    slab tests (``work``); raise unless the staged entries equal that
    count, which is below the per-key lists' entries."""
    ratio = unions["key_entries"] / max(1, unions["staged"])
    print(f"directional sweep: {c['staged_entries']} union entries staged "
          f"(tile_unions: {unions['staged']}; the per-key visit lists hold "
          f"{unions['key_entries']}, {ratio:.2f}x), "
          f"at most {unions['keys']} keys and {unions['largest']} union "
          f"entries in a tile; {c['slab_tests']} slab tests performed, "
          f"{int(work['slab_tests'])} needed, "
          f"{int(work['slab_tests_every_probe'])} at every probe")
    if unions["keys"] > shadow_dir.TABLE_KEYS:
        raise RuntimeError(f"directional sweep: a tile holds "
                           f"{unions['keys']} keys, over the table's "
                           f"{shadow_dir.TABLE_KEYS}")
    if c["staged_entries"] != unions["staged"]:
        raise RuntimeError(f"directional sweep: the kernel staged "
                           f"{c['staged_entries']} union entries, "
                           f"tile_unions counts {unions['staged']}")
    if not unions["staged"] < unions["key_entries"]:
        raise RuntimeError("directional sweep: the unions are no smaller "
                           "than the per-key lists")


def shade_grid(tag: str, cfg, frames: int, card: str) -> None:
    """Print the winner-input mode's launch geometry on ``cfg`` at F =
    ``frames``: its bands, chunk and grid, and its shared memory, blocks
    per SM, registers and local memory (``shadow_cuda.shade_occupancy``);
    raise unless the shared memory is the Python mirror's."""
    smem, blocks, regs, local = shadow_cuda.shade_occupancy(cfg)
    bands, rows = trace_cuda.bands(cfg), trace_cuda.band_rows(cfg)
    print(f"{tag} shadow_shade kernel: {bands} bands of {rows} rows a tile, "
          f"chunks of {shadow_cuda.shade_chunk(cfg)} list entries: grid "
          f"{cfg.hash_width * cfg.hash_height} columns x {frames} frames x "
          f"{bands} bands of {shadow_cuda.MARCH_THREADS} threads; {smem} B "
          f"of shared memory per block ({cfg.hash_volume}-bin grid), "
          f"{blocks} blocks per SM, {regs} registers and {local} B of local "
          f"memory a thread  [{card}]")
    if smem != shadow_cuda.shade_smem_bytes(cfg):
        raise RuntimeError(f"{tag}: the winner-input kernel takes {smem} B "
                           f"of shared memory, shade_smem_bytes "
                           f"{shadow_cuda.shade_smem_bytes(cfg)}")


def wide_grid_phase(card: str) -> list[dict]:
    """One frame of config 5's scene generator on WIDE_GRID through
    ``AnimationRenderer.render_states``, the launch counts set to 0 just
    before and read just after (trace 1, winner-input mode 1): raises
    unless the kernels equal their plain versions on it, frame 0 equals
    ``cpp_render_frame`` and the winner-input kernel's counters show its
    list path.  Returns the kernels' JSON rows."""
    tag = "wide grid"
    cfg = WIDE_GRID
    t0 = time.perf_counter()
    scene = config5_scene(config=cfg)
    r = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg)
    players = torch.as_tensor(scene.pos[:1], device=ds.pos.device)
    lights = torch.tensor([CONFIG5_LIGHT], dtype=torch.int32,
                          device=ds.pos.device)
    torch.cuda.synchronize()
    print(f"{tag}: {scene.n_entities} boxes on {cfg.view_width}x"
          f"{cfg.view_height}, bins of {cfg.bin_size} pixels "
          f"({cfg.hash_width}x{cfg.hash_height}x{cfg.hash_length} = "
          f"{cfg.hash_volume}), set-up {time.perf_counter() - t0:.2f} s")
    shade_grid(tag, cfg, 1, card)
    shadow_cuda.counters.reset()
    frames, launches = drive(f"{tag} two-kernel path", anim, ds, players,
                             lights, {"trace": 1, "shadow_shade": 1})
    list_path(f"{tag} two-kernel path", "shadow kernel (winner inputs)",
              shadow_cuda.counters.read(), cfg.view_width * cfg.view_height)
    t0 = time.perf_counter()
    golden, _ = oracle_frame(scene, players[0].tolist(), lights[0].tolist(),
                             cfg)
    require_equal(tag, "frame 0 vs cpp_render_frame", frames[0].cpu(),
                  torch.from_numpy(golden))
    print(f"{tag} frame 0: pixel-exact against cpp_render_frame "
          f"({time.perf_counter() - t0:.2f} s on the host)")
    be, cnt = batched.bin_stage(r, cache, ds, players)
    rows = path_kernels(tag, ds, be, cnt, players, lights, cfg, card,
                        {k: n for k, n in launches.items() if n})
    del ds, cache, anim, frames, be, cnt
    torch.cuda.empty_cache()
    return rows


BINNING_SOURCE = ("pixel_art_raytracer_tpu_torch/csrc/binning.cu",
                  "none: the full rebin, XLA's sort in "
                  "pixel_art_raytracer_tpu/ops/binning.py")
BINNING_REPS = 100
# Offsets of the player in the binning phase's four frames.
BINNING_PLAYERS = [[0, 0, 0], [40, 0, 0], [-30, 5, 20], [200, 10, -10]]
# A 40 x 40 x 40 grid (bins of 4 pixels): 64,000 bins, eight tiles of the
# binning kernel's count pass.
TILED_GRID = RenderConfig(view_width=160, view_height=160, view_length=160,
                          bin_size=4)
BINNING_KERNELS = ("bin_count_kernel", "bin_place_kernel")


def kernel_device_ms(fn, reps: int, names) -> float:
    """Mean device milliseconds a call of ``fn()`` spends in the kernels
    whose names contain one of ``names``, from a torch profiler over
    ``reps`` calls after one warm-up call: the kernels' own time where a
    call's launches cost the host more than the card (CUDA events
    around back-to-back calls would time the host)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.key_averages()
             if any(n in ev.key for n in names))
    return us / 1e3 / reps


def binning_call(tag: str, *args, **kwargs):
    """``binning.bin_tables(*args, **kwargs)`` on the card; raises unless
    it launched the binning kernel twice."""
    before = binning_cuda.launches
    got = binning.bin_tables(*args, **kwargs)
    if binning_cuda.launches != before + 2:
        raise RuntimeError(f"{tag}: the binning kernel launched "
                           f"{binning_cuda.launches - before} times, not 2")
    return got


def binning_phase(card: str) -> list[dict]:
    """The binning kernel on graybox (F = 1), config 5 at s = 2, WIDE_GRID
    and TILED_GRID: raises unless its tables equal ``binning.plain_tables``
    on the card and ``cpp_build_bins``, and its static-cache layout (window
    capacity + 1) the plain version's, with two launches a call; on
    graybox also with ``players`` as the live frame's full rebin passes
    them (``pos[:1]``), and for BINNING_PLAYERS' four frames against the
    plain version.  Prints its time, the plain version's and its bound
    (each box's ``pos`` and ``ext`` read once, the tables written once);
    returns its JSON rows."""
    cases = {
        "graybox": (graybox_world(DEFAULT_CONFIG), DEFAULT_CONFIG),
        "config 5, s = 2": (scale_scene(config5_scene(), 2),
                            scaled_config(bench_scale.CONFIG, 2)),
        "52x52x8 grid": (config5_scene(config=WIDE_GRID), WIDE_GRID),
        "40x40x40 grid": (overlap_scene(TILED_GRID, n_side=40), TILED_GRID),
    }
    rows = []
    for tag, (scene, cfg) in cases.items():
        spans = binning.entity_span_bound(scene.ext.max(axis=0), cfg)
        ds = DeviceScene.from_scene(scene, cfg)
        cap = cfg.bin_capacity
        for window, ring in ((cap, True), (cap + 1, False)):
            args = (ds.pos, ds.ext, None, cfg, spans, window, ring)
            got = binning_call(tag, *args)
            want = binning.plain_tables(*args)
            for what, g, w in zip(("ids", "counts"), got, want):
                require_equal(tag, f"binning kernel {what} at window "
                              f"{window}", g, w)
            if ring:
                be, cnt = got
        obe, ocnt = native.cpp_build_bins(scene, cfg)
        require_equal(tag, "binning kernel vs cpp_build_bins",
                      be[0].cpu(), torch.from_numpy(obe))
        require_equal(tag, "binning kernel counts vs cpp_build_bins",
                      cnt[0].cpu(), torch.from_numpy(ocnt))
        if tag == "graybox":
            live = binning_call(tag, ds.pos, ds.ext, ds.pos[:1], cfg, spans,
                                cap, ring=True)
            for what, g, w in zip(("ids", "counts"), live, (be, cnt)):
                require_equal(tag, f"binning kernel {what} with players "
                              f"pos[:1]", g, w)
            players = ds.pos[:1] + torch.tensor(BINNING_PLAYERS,
                                                dtype=torch.int32,
                                                device=ds.pos.device)
            args = (ds.pos, ds.ext, players, cfg, spans, cap, True)
            for what, g, w in zip(("ids", "counts"), binning_call(tag, *args),
                                  binning.plain_tables(*args)):
                require_equal(tag, f"binning kernel {what} for "
                              f"{len(BINNING_PLAYERS)} players", g, w)
            print(f"{tag} binning kernel: == with players pos[:1], and == "
                  f"plain version for {len(BINNING_PLAYERS)} players")
        args = (ds.pos, ds.ext, None, cfg, spans, cap, True)
        ms = kernel_device_ms(lambda: binning.bin_tables(*args),
                              BINNING_REPS, BINNING_KERNELS)
        call_ms = cuda_ms(lambda: binning.bin_tables(*args), BINNING_REPS)
        plain_ms = cuda_ms(lambda: binning.plain_tables(*args), TIMED_REPS)
        n_bytes = nbytes(ds.pos, ds.ext, be, cnt)
        bound_ms, bound_by = bound(n_bytes, 0)
        print(f"{tag} binning kernel: == plain version and cpp_build_bins, "
              f"static layout == plain; {scene.n_entities} boxes, "
              f"{cfg.hash_volume} bins, {binning_cuda.chunks(len(scene.pos))}"
              f" chunks, {binning_cuda.tiles(cfg)} tiles, "
              f"{binning_cuda.smem_bytes(cfg)} B of shared memory a count "
              f"block; {ms:.4f} ms on the card (a call back to back "
              f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}, {ms / bound_ms:.1f}x) per "
              f"call, 2 launches  [{card}]")
        rows.append({"name": f"binning {tag}", "route": "cuda",
                     "source": BINNING_SOURCE[0],
                     "replaces": BINNING_SOURCE[1], "launches": 2,
                     "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        del ds, be, cnt, got, want
    torch.cuda.empty_cache()
    return rows


def reset_launches() -> None:
    trace_cuda.launches = shadow_cuda.launches = fused_cuda.launches = 0
    shadow_cuda.directional_launches = shadow_cuda.shade_launches = 0
    binning_cuda.launches = 0


read_launches = bench.launch_counts

# The G-buffer chain's functions that the main path must not call.
GLUE = ((trace, "materialize_gbuffer"), (shade, "light_geometry"),
        (shade, "lambert_dot"), (shade, "factor_from_dot"),
        (shade, "shade_u8"))


@contextlib.contextmanager
def glue_calls():
    """Count the calls of the G-buffer chain's functions (``GLUE``) while
    the block runs; yields the dict of counts, by name."""
    calls = {name: 0 for _, name in GLUE}
    saved = [(mod, name, getattr(mod, name)) for mod, name in GLUE]

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def drive(label: str, anim, ds, players, lights, want: dict[str, int],
          directional: bool = False):
    """One batch through ``anim.render_states``, every launch count set to
    0 just before and read just after; raises unless the counts are
    ``want``.  Returns the frames and the counts."""
    reset_launches()
    frames = anim.render_states(ds, players, lights,
                                directional=directional)
    return frames, launches_are(f"{label}, per batch", want)


def direction_sweep(n: int, device) -> torch.Tensor:
    """(n, 3) float32 directions toward the light, (cos t, 1, 0.5 sin t)
    for t = 2 pi f / n."""
    t = 2.0 * np.pi * np.arange(n) / n
    d = np.stack([np.cos(t), np.ones(n), 0.5 * np.sin(t)], axis=1)
    return torch.as_tensor(d.astype(np.float32), device=device)


def require_equal(name: str, what: str, got: torch.Tensor,
                  want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: {what} differs at "
                           f"{int((got != want).sum())} elements")


def timed(fn):
    """``(fn(), ms)``: one call between two CUDA events, no warm-up (for
    the plain versions, which run once)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def config5_phase(card: str) -> list[dict]:
    """BASELINE config 5 at s = 2 and 4 through
    ``AnimationRenderer.render_states`` on ``SupersampledRenderer``'s
    renderer, on the two-kernel and the fused path.  Raises unless each
    kernel equals its plain version on the checked frames, the launch
    counters rose, both paths' frames are equal, frame 0 equals
    ``cpp_render_frame`` of the scaled scene, and
    ``SupersampledRenderer.render`` of frame 0 equals the box filter of
    that oracle frame.  Prints the launch grid, shared memory and blocks
    per SM, the march counters, peak memory, the kernels' times beside
    their plain versions and bounds, and ms/frame and Mrays/s at the traced
    size.  Returns the kernels' JSON rows."""
    t0 = time.perf_counter()
    scene = config5_scene()
    print(f"config 5: {scene.n_entities} boxes, base "
          f"{CONFIG5.view_width}x{CONFIG5.view_height}, F={CONFIG5_FRAMES}, "
          f"built in {time.perf_counter() - t0:.2f} s")
    rows = []
    for s in sorted(CONFIG5_CHECKED):
        tag = f"config 5, s={s}"
        t0 = time.perf_counter()
        ss = SupersampledRenderer(CONFIG5, s)
        cfg = ss.config
        r = ss.renderer
        ds = ss.prepare(scene)
        scaled = scale_scene(scene, s)
        cache = StaticBins(scaled.pos, scaled.ext, 1, cfg, r.spans)
        anim = AnimationRenderer(r, cfg, static_bins=cache)
        players, lights = anim.light_sweep_states(
            CONFIG5_FRAMES, scaled.pos[0],
            center=tuple(c * s for c in CONFIG5_LIGHT), radius=40 * s)
        H, W = cfg.view_height, cfg.view_width
        n_pix = CONFIG5_FRAMES * H * W
        torch.cuda.synchronize()
        print(f"{tag}: {W}x{H}, bins of {cfg.bin_size} pixels "
              f"({cfg.hash_width}x{cfg.hash_height}x{cfg.hash_length}), "
              f"spans {r.spans}, set-up {time.perf_counter() - t0:.2f} s")
        print(f"{tag}: trace and fused kernels walk each tile in "
              f"{trace_cuda.bands(cfg)} bands of {trace_cuda.band_rows(cfg)} "
              f"rows: grid {cfg.hash_width * cfg.hash_height} columns x "
              f"{trace_cuda.bands(cfg)} bands x {CONFIG5_FRAMES} frames")
        for k, occ, threads in (
                ("trace", trace_cuda.occupancy(cfg),
                 trace_cuda.block_threads(cfg)),
                ("shadow", shadow_cuda.occupancy(cfg),
                 shadow_cuda.march_threads(cfg)),
                ("fused", fused_cuda.occupancy(cfg),
                 fused_cuda.block_threads(cfg))):
            smem, blocks, regs, local = occ
            print(f"{tag} {k} kernel: {smem} B of shared memory per block, "
                  f"{blocks} blocks per SM at {threads} threads, {regs} "
                  f"registers and {local} B of local memory a thread  "
                  f"[{card}]")
        shade_grid(tag, cfg, CONFIG5_FRAMES, card)

        # The main path, both settings of fuse_trace_shadow.
        none = dict.fromkeys(read_launches(), 0)
        frames, launches = {}, {}
        for fuse, want in ((False,
                            {**none, "trace": 1, "shadow_shade": 1}),
                           (True, {**none, "fused": 1})):
            r.fuse_trace_shadow = fuse
            label = "fused" if fuse else "two-kernel"
            counters = fused_cuda.counters if fuse else shadow_cuda.counters
            counters.reset()
            torch.cuda.reset_peak_memory_stats()
            frames[fuse], got = drive(f"{tag} {label} path", anim, ds,
                                      players, lights, want)
            launches.update({k: n for k, n in got.items() if n})
            c = counters.read()
            list_path(f"{tag} {label} path",
                      "fused kernel" if fuse
                      else "shadow kernel (winner inputs)", c, n_pix)
            print(f"{tag} {label} path: {c['direct_pixels'] / n_pix:.6f} "
                  f"of the pixels marched directly; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require_equal(tag, "fused-path frames vs two-kernel frames",
                      frames[True], frames[False])
        print(f"{tag}: fused-path frames == two-kernel frames, all "
              f"{CONFIG5_FRAMES} frames")

        # Frame 0 against the oracle; the box-filtered frame.
        t0 = time.perf_counter()
        golden, _ = oracle_frame(scaled, players[0].tolist(),
                                 lights[0].tolist(), cfg)
        oracle_s = time.perf_counter() - t0
        bad = int((frames[False][0].cpu().numpy() != golden).any(axis=-1)
                  .sum())
        if bad:
            raise RuntimeError(f"{tag} frame 0: {bad} pixels differ from "
                               f"cpp_render_frame")
        base_light = lights[0].cpu().numpy()
        if (base_light % s).any():
            raise RuntimeError(f"{tag}: light {base_light} is not the "
                               f"scaled base light")
        r.fuse_trace_shadow = False
        small = ss.render(ds, base_light // s)
        require_equal(tag, "SupersampledRenderer.render of frame 0 vs the "
                      "box-filtered oracle", small.cpu(),
                      box_filter(torch.from_numpy(golden), s))
        launches["shadow"] = gbuffer_frame_is(tag, r, ds, lights[0], golden)
        print(f"{tag} frame 0: both paths pixel-exact against "
              f"cpp_render_frame ({oracle_s:.2f} s on the host); "
              f"SupersampledRenderer.render == its box filter "
              f"({CONFIG5.view_width}x{CONFIG5.view_height})")

        # Each kernel against its plain version on the checked frames.
        pick = CONFIG5_CHECKED[s]
        print(f"{tag}: the kernels against their plain versions on frames "
              f"{pick}")
        be, cnt = batched.bin_stage(r, cache, ds, players[pick])
        rows += path_kernels(tag, ds, be, cnt, players[pick], lights[pick],
                             cfg, card, launches)

        # End to end: ms/frame and Mrays/s at the traced size.
        rays = 2 * W * H * CONFIG5_FRAMES
        e2e = {}
        for fuse in (False, True, True, False):
            r.fuse_trace_shadow = fuse
            e2e.setdefault(fuse, []).append(cuda_ms(
                lambda: anim.render_states(ds, players, lights), TIMED_REPS))
        for fuse, label in ((False, "two-kernel"), (True, "fused")):
            m = float(np.mean(e2e[fuse]))
            print(f"{tag} {label}: F={CONFIG5_FRAMES} "
                  f"{m / CONFIG5_FRAMES:.4f} ms/frame, "
                  f"{rays / (m * 1e3):.2f} Mrays/s at {W}x{H}  [{card}]")
        r.fuse_trace_shadow = False

        for label, stages in (("two-kernel", main_path_stages),
                              ("G-buffer mode", gbuffer_stages)):
            split = stage_split(stages(r, cache, ds, players, lights),
                                TIMED_REPS, CONFIG5_FRAMES)
            print(f"{tag} {label} stage split, ms/frame at "
                  f"F={CONFIG5_FRAMES}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"  [{card}]")
        del ds, cache, anim, frames, be, cnt
        torch.cuda.empty_cache()
    return rows


def path_launches_are(tag: str, tally: dict, got: dict[str, int],
                      rebins: int = 0) -> None:
    """Raise unless each path of a bench's launch ``tally`` (path ->
    batches and launches, ``bench.on_path``) launched exactly trace 1 +
    shadow 1 (two-kernel) or fused 1 (fused) a batch, the two-kernel path
    the binning kernel's 2 for each of its ``rebins`` full rebins (single
    frames), and the launch counts ``got`` of the whole run are the paths'
    sum and the 2 binning launches of the run's ``StaticBins`` cache."""
    for path, kinds in (("two_kernel", ("trace", "shadow_shade")),
                        ("fused", ("fused",))):
        counts = {k: n for k, n in tally[path].items() if k != "batches"}
        want = {k: tally[path]["batches"] if k in kinds else 0
                for k in counts}
        if path == "two_kernel":
            want["binning"] = 2 * rebins
        print(f"{tag}, {path} path: {tally[path]['batches']} batches, "
              f"launches {counts}")
        if counts != want:
            raise RuntimeError(f"{tag}, {path} path: launches {counts}, "
                               f"expected {want}")
    total = {k: sum(t[k] for t in tally.values()) for k in got}
    total["binning"] += 2
    if total != got:
        raise RuntimeError(f"{tag}: launches {got} in the run, the paths "
                           f"and the cache count {total}")


def bench_phase(card: str, scene) -> None:
    """``bench.run`` on graybox (F = 64, 3 repeats, no settle-wait), the
    launch counts set to 0 just before and read just after.  Raises unless
    center frame 0 of both paths' timed output equals ``cpp_render_frame``
    and each path launched exactly its kernels once a batch (trace and
    the winner-input mode of shadow.cu, or fused).  Prints the bench's JSON
    line."""
    t0 = time.perf_counter()
    reset_launches()
    result = bench.run("cuda", scene, DEFAULT_CONFIG, FRAMES, BENCH_REPEATS,
                       bench.BURSTS, settle_s=0)
    torch.cuda.synchronize()
    got = read_launches()
    if any(result.differing.values()):
        raise RuntimeError(f"bench: pixels of center frame 0 differing from "
                           f"cpp_render_frame {result.differing}")
    path_launches_are("bench", result.summary["launches"], got)
    print(f"bench: parity on both paths, {time.perf_counter() - t0:.2f} s "
          f"in all  [{card}]")
    print(json.dumps(result.summary))


def bench_scale_phase(card: str) -> list[dict]:
    """``bench_scale.run`` on config 5 with the non-ramp atlas (a depth map
    that varies along a row) at s = 2 and 4, the launch counts set to 0
    just before and read just after each.  Raises unless frame 0 of both
    paths equals ``cpp_render_frame`` of the scaled scene, ``render`` its
    box filter, each path launched exactly its kernels, and each kernel
    equals its plain version on frame 0.  The G-buffer mode of shadow.cu,
    which the bench's paths no longer launch, is driven by
    ``render_with_gbuffer`` on frame 0's state (:func:`gbuffer_frame_is`)
    and held to its plain version too.  Prints the bench's JSON lines;
    returns the kernels' JSON rows."""
    scene = config5_scene(nonramp=True)
    rows = []
    for s in (2, 4):
        tag = f"config 5 non-ramp, s={s}"
        t0 = time.perf_counter()
        reset_launches()
        result = bench_scale.run("cuda", scene, s, BENCH_SCALE_ITERS,
                                 CONFIG5_FRAMES)
        torch.cuda.synchronize()
        got = read_launches()
        if any(result.differing.values()):
            raise RuntimeError(f"{tag}: pixels differing from "
                               f"cpp_render_frame {result.differing}")
        # Single frames: BENCH_SCALE_ITERS + 1 timed and one base-size frame.
        path_launches_are(tag, result.summary["launches"], got,
                          rebins=BENCH_SCALE_ITERS + 2)
        print(f"{tag}: frame 0 of both paths == cpp_render_frame, render == "
              f"its box filter; {time.perf_counter() - t0:.2f} s  [{card}]")
        print(json.dumps(result.summary))
        r, ds = result.renderer, result.dscene
        players, lights = result.players[:1], result.lights[:1]
        got["shadow"] = gbuffer_frame_is(tag, r, ds, lights[0],
                                         r.render(ds, lights[0]).cpu())
        be, cnt = batched.bin_stage(r, result.cache, ds, players)
        rows += path_kernels(tag, ds, be, cnt, players, lights, r.config,
                             card, got)
        del result, r, ds, be, cnt
        torch.cuda.empty_cache()
    return rows


def make_demo_phase(card: str, scene) -> None:
    """``make_demo``'s 32-frame graybox sweep (one batch: trace 1 + the
    winner-input mode of shadow.cu 1), written into a temporary directory;
    raises unless the GIF and the PNG are ``docs/``'s byte for byte."""
    t0 = time.perf_counter()
    reset_launches()
    frames = make_demo.render_sweep(scene, DEFAULT_CONFIG, make_demo.FRAMES,
                                    "cuda")
    launches_are("make_demo", {"trace": 1, "shadow_shade": 1,
                               "binning": 2})
    with tempfile.TemporaryDirectory(dir=native.BUILD_ROOT) as tmp:
        encoder = make_demo.write_demo(tmp, frames)
        for name in ("graybox_sweep.gif", "graybox_frame.png"):
            got = pathlib.Path(tmp, name).read_bytes()
            want = (make_demo.DOCS / name).read_bytes()
            if got != want:
                raise RuntimeError(f"make_demo: {name} ({len(got)} B) "
                                   f"differs from docs/{name} ({len(want)} "
                                   f"B)")
            print(f"make_demo: {name} == docs/{name}, {len(got)} B")
    print(f"make_demo: {make_demo.FRAMES} frames, {encoder} encoder, "
          f"{time.perf_counter() - t0:.2f} s  [{card}]")


def gbuffer_frame_is(tag: str, r, ds, light, want) -> int:
    """``r.render_with_gbuffer`` of the player where ``ds`` puts it under
    ``light``, the launch counts set to 0 just before and read just after:
    raises unless it launched trace 1 + the G-buffer mode of shadow.cu 1
    + binning 2 (its full rebin) and its frame equals ``want`` (H, W, 3) (an array or a tensor).
    Returns the G-buffer mode's launches (1), for its kernel row on the
    path ``tag``."""
    reset_launches()
    _, frame = r.render_with_gbuffer(ds, light)
    got = launches_are(f"{tag}, render_with_gbuffer (G-buffer mode)",
                       {"trace": 1, "shadow": 1, "binning": 2})
    require_equal(tag, "render_with_gbuffer frame", frame.cpu(),
                  torch.as_tensor(want))
    return got["shadow"]


def path_kernels(tag: str, ds, be, cnt, players, lights, cfg, card: str,
                 launches: dict[str, int], gbuf=None) -> list[dict]:
    """Hold each kernel that ``launches`` (name -> launches of one run of
    the path ``tag``) counted against its plain version on one batch of
    that path's inputs: the bins (F, V, cap) and (F, V), the players and
    point lights (F, 3), and, where the path's G-buffer does not come from
    the trace kernel (the brute renderer), that G-buffer.  Raises on any
    difference; prints and returns the kernels' JSON rows, with their
    times, plain times and bounds on these inputs."""
    args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, players,
            cfg)
    rows_b = entity_bytes(be, cnt, ds.pos, ds.ext, ds.sprite_id)
    ms, errs, bounds, work, stats = {}, {}, {}, {}, {}
    key_ops = 0
    if gbuf is None:
        (best_p, win_p), ms["trace_plain"] = timed(
            lambda: trace.trace_winner(*args, work=work))
        key_ops = DEPTH_KEY_OPS * int(work["candidate_hits"])
        gbuf = trace.materialize_gbuffer(
            win_p, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, players, cfg)
        if launches.get("trace"):
            best_k, win_k = trace_cuda.trace_winners(*args, with_best=True)
            require_equal(tag, "trace kernel winner", win_k, win_p)
            require_equal(tag, "trace kernel best", best_k, best_p)
            errs["trace"] = max(max_abs_err(win_k, win_p),
                                max_abs_err(best_k, best_p))
            ms["trace"] = cuda_ms(lambda: trace_cuda.trace_winners(*args),
                                  KERNEL_REPS)
            bounds["trace"] = (rows_b + nbytes(ds.atlas_depth, be, cnt,
                                               players, win_k), key_ops)
    _, inv, origin, rb, lb = shade.light_geometry(gbuf, lights, cfg)
    sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
             inv, players, cfg)
    lit_p, ms["shadow_plain"] = timed(
        lambda: shadow.trace_light_dynamic(*sargs, work=work))
    shadow_ops = SLAB_OPS * int(work["slab_tests"])
    if launches.get("shadow"):
        shadow_cuda.counters.reset()
        lit_k = shadow_cuda.trace_light(*sargs)
        stats["shadow"] = shadow_cuda.counters.read()
        require_equal(tag, "shadow kernel lit", lit_k, lit_p)
        errs["shadow"] = max_abs_err(lit_k, lit_p)
        ms["shadow"] = cuda_ms(lambda: shadow_cuda.trace_light(*sargs),
                               KERNEL_REPS)
        light_bin = torch.stack([b.reshape(players.shape[0]) for b in lb],
                                dim=1)
        bounds["shadow"] = (
            entity_bytes(be, cnt, ds.pos, ds.ext)
            + nbytes(players, be, cnt, *rb, *origin, *inv,
                     gbuf.entity_index, light_bin, lit_k), shadow_ops)
    if launches.get("shadow_shade"):
        wargs = (win_p, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
                 ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt,
                 players, lights, cfg)
        frames_p, ms["shadow_shade_plain"] = timed(
            lambda: shade.point_frames(*wargs))
        shadow_cuda.counters.reset()
        frames_k = shadow_cuda.shade_point(*wargs)
        stats["shadow_shade"] = shadow_cuda.counters.read()
        lit_w = shadow_cuda.shade_point(*wargs, frames=False)
        require_equal(tag, "winner-input kernel frames", frames_k, frames_p)
        require_equal(tag, "winner-input kernel lit", lit_w, lit_p)
        errs["shadow_shade"] = max(max_abs_err(frames_k, frames_p),
                                   max_abs_err(lit_w, lit_p))
        ms["shadow_shade"] = cuda_ms(lambda: shadow_cuda.shade_point(*wargs),
                                     KERNEL_REPS)
        bounds["shadow_shade"] = (
            rows_b + nbytes(players, lights, be, cnt, win_p, ds.atlas_depth,
                            ds.atlas_color, ds.atlas_normal, ds.palette,
                            frames_k),
            shadow_ops + SHADE_OPS * win_p.numel())
    if launches.get("fused"):
        fargs = args[:-1] + (lights, cfg)
        (best_f, win_f, lit_f), ms["fused_plain"] = timed(
            lambda: fused.trace_shadow(*fargs))
        require_equal(tag, "plain fused winner vs trace_winner", win_f,
                      win_p)
        require_equal(tag, "plain fused lit vs trace_light_dynamic", lit_f,
                      lit_p)
        fused_cuda.counters.reset()
        best_k, win_k, lit_k = fused_cuda.trace_shadow(*fargs,
                                                       with_best=True)
        stats["fused"] = fused_cuda.counters.read()
        for what, got, want in (("winner", win_k, win_f),
                                ("best", best_k, best_f),
                                ("lit", lit_k, lit_f)):
            require_equal(tag, f"fused kernel {what}", got, want)
        errs["fused"] = max(max_abs_err(win_k, win_f),
                            max_abs_err(best_k, best_f),
                            max_abs_err(lit_k, lit_f))
        ms["fused"] = cuda_ms(lambda: fused_cuda.trace_shadow(*fargs),
                              KERNEL_REPS)
        bounds["fused"] = (rows_b + nbytes(ds.atlas_depth, be, cnt, players,
                                           lights, win_k, lit_k),
                           key_ops + shadow_ops)
    F, H, W = gbuf.y.shape
    print(f"{tag}: {int(work.get('candidate_hits', 0))} candidate hits, "
          f"{int(work['slab_tests'])} slab tests needed on F={F} {W}x{H} "
          f"frames")
    for k, c in stats.items():
        print(f"{tag} {k} kernel: {c['direct_pixels']} of {F * H * W} "
              f"pixels marched directly, at most {c['max_starts']} start "
              f"bins in a {'band' if k == 'fused' else 'tile'}, longest "
              f"visit list {c['max_list']} bins")
    rows = []
    for k, (src, rep) in SOURCES.items():
        if not launches.get(k):
            continue
        bound_ms, bound_by = bound(*bounds[k])
        print(f"{tag} {k} kernel == plain version, bit-exact; {ms[k]:.4f} "
              f"ms, plain {ms[k + '_plain']:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}, {ms[k] / bound_ms:.1f}x) per call on F={F} "
              f"{W}x{H} frames; {launches[k]} launches on the path  [{card}]")
        rows.append({"name": f"{k} ({tag})", "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k],
                     "max_abs_err": errs[k], "ms": ms[k],
                     "plain_ms": ms[k + "_plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return rows


def launches_are(tag: str, want: dict[str, int]) -> dict[str, int]:
    """The launch counts since the last ``reset_launches``; raises unless
    they are ``want`` (names missing from ``want`` are 0)."""
    torch.cuda.synchronize()
    got = read_launches()
    want = {**dict.fromkeys(got, 0), **want}
    print(f"{tag}: launches {got}")
    if got != want:
        raise RuntimeError(f"{tag}: launches {got}, expected {want}")
    return got


def oracle_frame(scene, player, light, config):
    """``cpp_render_frame`` with entity 0 at ``player``: ``(rgb, GBuffer)``."""
    pos = scene.pos.copy()
    pos[0] = player
    return native.cpp_render_frame(scene.replace_pos(pos), Light(*light),
                                   config)


def oracle_overlay(scene, player, light, mouse, line_x, config):
    """The oracle's frame with the session's red line drawn as the
    reference does (alternative.cpp:762-772): from column ``line_x`` at the
    hovered pixel's surface row, the hovered pixel read from
    ``cpp_trace_pixels``' y and z at the clamped ``mouse``, to the light.
    Returns ``(image, (y, z), GBuffer)``."""
    image, gb = oracle_frame(scene, player, light, config)
    mx = min(max(mouse[0], 0), config.view_width - 1)
    my = min(max(mouse[1], 0), config.view_height - 1)
    mp = (int(gb.y[my, mx]), int(gb.z[my, mx]))
    H = config.view_height
    draw_line_host(image, line_x, H - sum(mp), light[0],
                   H - (light[1] + light[2]), (255, 0, 0))
    return image, mp, gb


def brute_phase(card: str, scene, ds, renderer) -> list[dict]:
    """BASELINE config 1 through ``BruteForceRenderer`` on the card:
    raises unless its entity index equals ``cpp_trace_pixels``', its
    unshadowed frame the same renderer's frame on the CPU, and its
    ``shadow=True`` frame (one launch of the shadow kernel)
    ``cpp_render_frame``.  Then the brute trace of graybox at full width:
    its time, and the pixels whose winner differs from the deferred path's
    (printed, not gated: graybox's bins overflow).  Returns the shadow
    kernel's row on the brute path."""
    tag = "brute, config 1"
    b = SceneBuilder(config=CONFIG1)
    b.insert((10, 0, 10), (20, 20, 20))
    b.insert((30, 10, 20), (20, 20, 20))
    scene1 = b.build()
    ds1 = DeviceScene.from_scene(scene1, CONFIG1)
    light = CONFIG1_LIGHT.as_array()
    brute = BruteForceRenderer(CONFIG1)
    gbuf = brute.trace(ds1)
    be_c, cnt_c = native.cpp_build_bins(scene1, CONFIG1)
    want = native.cpp_trace_pixels(scene1, be_c, cnt_c, CONFIG1)
    require_equal(tag, "entity index vs cpp_trace_pixels",
                  gbuf.entity_index.cpu(), torch.from_numpy(want.entity_index))
    ds1_cpu = DeviceScene.from_scene(scene1, CONFIG1, device="cpu")
    require_equal(tag, "unshadowed frame vs the CPU's",
                  brute.render(ds1, light).cpu(), brute.render(ds1_cpu, light))
    shadowed = BruteForceRenderer(CONFIG1, shadow=True)
    reset_launches()
    frame = shadowed.render(ds1, light)
    launches = launches_are(f"{tag}, shadow=True",
                            {"shadow": 1, "binning": 2})
    golden, _ = native.cpp_render_frame(scene1, CONFIG1_LIGHT, CONFIG1)
    require_equal(tag, "shadow=True frame vs cpp_render_frame", frame.cpu(),
                  torch.from_numpy(golden))
    print(f"{tag}: entity index == cpp_trace_pixels, unshadowed frame == "
          f"the CPU's, shadow=True frame == cpp_render_frame")
    be, cnt = binning.build_bins(ds1.pos, ds1.ext, CONFIG1, SHADOW_SPANS)
    lights = torch.as_tensor(light, device=be.device)[None]
    rows = path_kernels(f"{tag}, shadow=True", ds1, be[None], cnt[None],
                        ds1.pos[:1], lights, CONFIG1, card, launches,
                        gbuf=GBufferArrays(*(t[None] for t in gbuf)))

    cfg = renderer.config
    brute = BruteForceRenderer(cfg)
    trace_ms = cuda_ms(lambda: brute.trace(ds), BRUTE_REPS)
    be, cnt = renderer.build_bins(ds)
    deferred = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                        ds.atlas_depth, be[None], cnt[None],
                                        ds.pos[:1], cfg)[0]
    differ = int((brute.winners(ds) != deferred).sum())
    print(f"brute, graybox: trace {trace_ms:.1f} ms a frame "
          f"({scene.n_entities} entities in chunks of {brute.entity_chunk}, "
          f"{cfg.view_width}x{cfg.view_height}); {differ} pixels' winners "
          f"differ from the deferred path's (its bins overflow)  [{card}]")
    return rows


def session_script(cfg) -> list[tuple[list[str], tuple[int, int]]]:
    """``SESSION_FRAMES`` frames of (keys, mouse): every binding in turn,
    two keys on every third frame, the cursor seeded inside the frame and
    around it."""
    bindings = list(KEY_BINDINGS)
    rng = np.random.default_rng(7)
    W, H = cfg.view_width, cfg.view_height
    script = []
    for f in range(SESSION_FRAMES):
        keys = [bindings[f % len(bindings)]]
        if f % 3 == 2:
            keys.append(bindings[(5 * f) % len(bindings)])
        mouse = (int(rng.integers(-40, W + 40)),
                 int(rng.integers(-40, H + 40)))
        script.append((keys, mouse))
    # The checked frames: the cursor inside, on a corner, outside.
    for f, mouse in zip(SESSION_CHECKED,
                        ((W // 3, H // 2), (W - 1, 0), (-25, H + 30))):
        script[f] = (script[f][0], mouse)
    return script


def session_report(cfg, player, ext0, counts) -> str:
    """``Session.debug_report`` built from the oracle's bin counts (V,)."""
    counts = counts.reshape(cfg.hash_width, cfg.hash_height, cfg.hash_length)
    bx = min(max(player[0] // cfg.bin_size, 0), cfg.hash_width - 1)
    lines = [f"<{player[0]}, {player[1]}, {player[2]}>",
             f"<{player[0] + ext0[0]}, {player[1] + ext0[1]}, "
             f"{player[2] + ext0[2]}>"]
    lines += [" ".join(str(counts[bx, j, k]) for k in range(cfg.hash_length))
              for j in range(cfg.hash_height)]
    return "\n".join(lines)


def session_phase(card: str, scene, cfg) -> list[dict]:
    """``Session`` on graybox on the card, ``SESSION_FRAMES`` frames of
    ``session_script`` on the two-kernel path, then the first
    ``SESSION_FUSED_FRAMES`` again with ``fuse_trace_shadow``.  Raises
    unless each frame launches trace 1 + shadow 1 (fused 1) and the
    binning kernel's 2 (its full rebin); the images of
    frames ``SESSION_CHECKED`` and their mouse readouts equal
    ``cpp_render_frame`` with the red line drawn at endpoints from
    ``cpp_trace_pixels``' y and z; ``debug_report()`` equals the report
    built from ``cpp_build_bins``' counts and ``normal_view()`` the debug
    colours of the oracle's normals, at the final state; the fused
    session's images equal the two-kernel session's; and ``save_gif``
    runs the native encoder.  Returns the kernels' rows on both paths."""
    script = session_script(cfg)
    s = Session(scene, config=cfg)
    states, ms = [], []
    reset_launches()
    for keys, mouse in script:
        t0 = time.perf_counter()
        s.feed(keys, mouse)
        ms.append((time.perf_counter() - t0) * 1e3)
        states.append((s.state.player_pos.tolist(), s.state.light.tolist(),
                       s.mouse))
    launches = launches_are(f"session, {SESSION_FRAMES} frames",
                            {"trace": SESSION_FRAMES,
                             "shadow": SESSION_FRAMES,
                             "binning": 2 * SESSION_FRAMES})
    print(f"session: feed {float(np.median(ms[1:])):.2f} ms/frame (median "
          f"of frames 1-{SESSION_FRAMES - 1}; frame 0 {ms[0]:.2f} ms), "
          f"{cfg.view_width}x{cfg.view_height}, {scene.n_entities} entities "
          f"rebinned every frame  [{card}]")
    for f in SESSION_CHECKED:
        player, light, mouse = states[f]
        image, mp, _ = oracle_overlay(scene, player, light, mouse, mouse[0],
                                      cfg)
        rec = s.frames[f]
        require_equal("session", f"frame {f} image vs cpp_render_frame + "
                      "the red line", torch.from_numpy(rec.image),
                      torch.from_numpy(image))
        if (rec.mouse_pixel_y, rec.mouse_pixel_z) != mp:
            raise RuntimeError(f"session frame {f}: mouse pixel "
                               f"{(rec.mouse_pixel_y, rec.mouse_pixel_z)}, "
                               f"oracle {mp}")
    player, light, _ = states[-1]
    _, gb = oracle_frame(scene, player, light, cfg)
    pos = scene.pos.copy()
    pos[0] = player
    _, counts = native.cpp_build_bins(scene.replace_pos(pos), cfg)
    report = session_report(cfg, player, scene.ext[0].tolist(), counts)
    if s.debug_report() != report:
        raise RuntimeError(f"session debug_report:\n{s.debug_report()}\n"
                           f"oracle:\n{report}")
    with np.errstate(invalid="ignore"):
        normals = np.stack(normal_to_debug_color(
            gb.normal[..., 0], gb.normal[..., 1], gb.normal[..., 2]), -1)
    require_equal("session", "normal_view vs the oracle's normals",
                  torch.from_numpy(s.normal_view()), torch.from_numpy(normals))
    with tempfile.TemporaryDirectory(dir=native.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "session.gif")
        encoder = s.save_gif(path)
        size = os.path.getsize(path)
    if encoder != "native":
        raise RuntimeError(f"session save_gif ran the {encoder} encoder")
    print(f"session: frames {list(SESSION_CHECKED)} == cpp_render_frame + "
          f"the red line, mouse readouts, debug_report and normal_view == "
          f"the oracle's; save_gif: native encoder, {size} B")
    ds_f = scene_with_player(s.dscene, player)
    be, cnt = s.renderer.build_bins(ds_f)
    players = ds_f.pos[:1]
    lights = torch.tensor([light], dtype=torch.int32, device=be.device)
    rows = path_kernels("session", ds_f, be[None], cnt[None], players,
                        lights, cfg, card, launches)

    r = DeferredRenderer(cfg)
    r.fuse_trace_shadow = True
    s_fused = Session(scene, config=cfg, renderer=r)
    reset_launches()
    for keys, mouse in script[:SESSION_FUSED_FRAMES]:
        s_fused.feed(keys, mouse)
    launches = launches_are(f"session, fused, {SESSION_FUSED_FRAMES} frames",
                            {"fused": SESSION_FUSED_FRAMES,
                             "binning": 2 * SESSION_FUSED_FRAMES})
    for f in range(SESSION_FUSED_FRAMES):
        require_equal("fused session", f"frame {f} vs the two-kernel "
                      "session", torch.from_numpy(s_fused.frames[f].image),
                      torch.from_numpy(s.frames[f].image))
    print(f"session, fused: frames 0-{SESSION_FUSED_FRAMES - 1} == the "
          f"two-kernel session's")
    return rows + path_kernels("session, fused", ds_f, be[None], cnt[None],
                               players, lights, cfg, card, launches)


def viewer_phase(card: str, scene, cfg) -> list[dict]:
    """``LiveViewer`` on graybox on the card through ``bench_loop``, the
    viewer's --bench loop, for ``VIEWER_FRAMES`` frames.  Raises unless
    each frame launches trace 1 + shadow 1 + binning 2 and frame 0's
    image equals
    ``cpp_render_frame`` with the red line from the clamped cursor.
    Prints the loop's median ms/frame and the share of render + overlay
    in it.  Returns the kernels' rows on the viewer's path."""
    v = LiveViewer(scene, config=cfg)
    render_overlay = v._render_with_overlay
    render_ms, first = [], {}

    def timed_render_overlay():
        state = (v.state.player_pos.tolist(), v.state.light.tolist(),
                 v.mouse)
        t0 = time.perf_counter()
        image = render_overlay()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        first.setdefault("frame", (state, image.copy(), v.mouse_pixel))
        return image

    v._render_with_overlay = timed_render_overlay
    reset_launches()
    n, steps, wall = bench_loop(v, VIEWER_FRAMES)
    launches = launches_are(f"viewer, {n} frames",
                            {"trace": VIEWER_FRAMES,
                             "shadow": VIEWER_FRAMES,
                             "binning": 2 * VIEWER_FRAMES})
    loop = float(np.median(steps)) * 1e3
    render = float(np.median(render_ms[1:]))
    print(f"viewer --bench loop: {n} frames, median {loop:.2f} ms/frame "
          f"({1e3 / loop:.1f} fps), render + overlay {render:.2f} ms "
          f"({render / loop:.3f} of the loop), ANSI blit and the rest "
          f"{loop - render:.2f} ms; scale {v.scale}, wall {wall:.2f} s  "
          f"[{card}]")
    (player, light, mouse), image, mp = first["frame"]
    mx = min(max(mouse[0], 0), cfg.view_width - 1)
    want, want_mp, _ = oracle_overlay(scene, player, light, mouse, mx, cfg)
    require_equal("viewer", "frame 0 image vs cpp_render_frame + the red "
                  "line", torch.from_numpy(image), torch.from_numpy(want))
    if mp != want_mp:
        raise RuntimeError(f"viewer frame 0: mouse pixel {mp}, oracle "
                           f"{want_mp}")
    print("viewer: frame 0 == cpp_render_frame + the red line")
    ds_f = scene_with_player(v.dscene, v.state.player_pos)
    players = ds_f.pos[:1]
    lights = v.state.light.to(players.device)[None]
    # The live frame's split: the batched stages at F = 1 with a full rebin
    # and the frame's fetch (CUDA events between them), then the blit.
    stages = gbuffer_stages(v.renderer, None, ds_f, players, lights)
    stages.append(("fetch", lambda st: st["frames"].cpu()))
    split = stage_split(stages, TIMED_REPS, frames=1)
    image = v.render_current()
    t0 = time.perf_counter()
    for _ in range(TIMED_REPS):
        ansi_frame(image, v.scale)
    blit = (time.perf_counter() - t0) * 1e3 / TIMED_REPS
    print("viewer frame split, ms: " + ", ".join(
        f"{k} {t:.4f}" for k, t in split.items())
        + f", ANSI blit on the host {blit:.2f}  [{card}]")
    be, cnt = v.renderer.build_bins(ds_f)
    return path_kernels("viewer", ds_f, be[None], cnt[None], players,
                        lights, cfg, card, launches)


def overlap_scene(config, n_side: int, seed: int = 3):
    """tests/test_configs.py:19-31 with the port's ``SceneBuilder``: the
    player and n_side**2 seeded 20-cubes at varied y and z."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((config.view_width // 2, 36, config.view_length // 4),
             (20, 20, 20))
    for _ in range(n_side * n_side):
        x = int(rng.integers(0, config.view_width - 4))
        y = int(rng.integers(0, 60))
        z = int(rng.integers(0, config.view_length - 4))
        b.insert((x, y, z), (20, 20, 20))
    return b.build()


def config2_phase(card: str) -> list[dict]:
    """BASELINE config 2: the 101-box overlap scene at 256 x 256, a
    32-frame light sweep through ``render_long`` in chunks of 8 into a
    checkpoint directory, then again after its last chunk is deleted.
    Raises unless the first run launches trace 4 + shadow 4 (the
    winner-input mode of shadow.cu) + binning 8 (a full rebin a chunk) and
    the second trace 1 + shadow 1 + binning 2, the
    two runs' frames are equal, frames 0 and 31 equal ``cpp_render_frame``,
    ``render_with_gbuffer`` of frame 0's state (the G-buffer mode) equals
    frame 0 and the GIF is written by the native encoder.  Prints ms/frame
    and Mrays/s.  Returns the kernels' rows."""
    cfg = CONFIG2
    scene = overlap_scene(cfg, n_side=10)
    r = DeferredRenderer(cfg).configure_for(scene)
    anim = AnimationRenderer(r, cfg)
    ds = DeviceScene.from_scene(scene, cfg)
    players, lights = anim.light_sweep_states(CONFIG2_FRAMES, scene.pos[0])
    chunks = CONFIG2_FRAMES // CONFIG2_CHUNK
    shade_grid("config 2", cfg, CONFIG2_CHUNK, card)
    with tempfile.TemporaryDirectory(dir=native.BUILD_ROOT) as tmp:
        reset_launches()
        t0 = time.perf_counter()
        frames = anim.render_long(ds, players, lights, tmp, CONFIG2_CHUNK)
        seconds = time.perf_counter() - t0
        launches = launches_are("config 2, render_long",
                                {"trace": chunks, "shadow_shade": chunks,
                                 "binning": 2 * chunks})
        os.remove(os.path.join(tmp, f"chunk_{chunks - 1:05d}.npz"))
        reset_launches()
        again = anim.render_long(ds, players, lights, tmp, CONFIG2_CHUNK)
        launches_are("config 2, render_long after its last chunk was "
                     "deleted", {"trace": 1, "shadow_shade": 1,
                                 "binning": 2})
        if not np.array_equal(again, frames):
            raise RuntimeError("config 2: the resumed render's frames differ")
        path = os.path.join(tmp, "config2.gif")
        encoder = write_gif(path, frames)
        size = os.path.getsize(path)
    H, W = cfg.view_height, cfg.view_width
    if frames.shape != (CONFIG2_FRAMES, H, W, 3) or encoder != "native":
        raise RuntimeError(f"config 2: frames {frames.shape}, GIF encoder "
                           f"{encoder}")
    for f in (0, CONFIG2_FRAMES - 1):
        golden, _ = oracle_frame(scene, players[f].tolist(),
                                 lights[f].tolist(), cfg)
        require_equal("config 2", f"frame {f} vs cpp_render_frame",
                      torch.from_numpy(frames[f]), torch.from_numpy(golden))
    launches = {**launches, "shadow": gbuffer_frame_is(
        "config 2", r, ds, lights[0], torch.from_numpy(frames[0]))}
    stats = RenderStats(CONFIG2_FRAMES, H, W, seconds)
    batch_ms = cuda_ms(lambda: anim.render_states(
        ds, players[:CONFIG2_CHUNK], lights[:CONFIG2_CHUNK]), TIMED_REPS)
    batch = RenderStats(CONFIG2_CHUNK, H, W, batch_ms / 1e3)
    print(f"config 2: {scene.n_entities} boxes, {CONFIG2_FRAMES} frames "
          f"through render_long in chunks of {CONFIG2_CHUNK}: "
          f"{1e3 / stats.frames_per_sec:.4f} ms/frame, "
          f"{stats.mrays_per_sec:.2f} Mrays/s with the checkpoints written; "
          f"render_states {1e3 / batch.frames_per_sec:.4f} ms/frame, "
          f"{batch.mrays_per_sec:.2f} Mrays/s; the resume re-rendered 1 "
          f"chunk, same frames; frames 0 and {CONFIG2_FRAMES - 1} == "
          f"cpp_render_frame; GIF {size} B (native)  [{card}]")
    be, cnt = batched.bin_stage(r, None, ds, players[:CONFIG2_CHUNK])
    return path_kernels("config 2", ds, be, cnt, players[:CONFIG2_CHUNK],
                        lights[:CONFIG2_CHUNK], cfg, card, launches)


def kernel_row(name: str, kernel: str, launches: int, err: int, ms: float,
               plain_ms: float, n_bytes: float, n_ops: float, what: str,
               card: str) -> dict:
    """Print a kernel's check and times on ``what``; its JSON row."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"{name}: kernel == plain version, bit-exact; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{ms / bound_ms:.1f}x) per call on {what}; {launches} launches "
          f"on the path  [{card}]")
    src, rep = SOURCES[kernel]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def window_tables(be, cnt, config, rows):
    """The bin columns of the bin rows of window ``rows`` (all for None):
    the tables a windowed trace reads, (F, V', cap) and (F, V')."""
    row0, n_rows = trace.row_window(config, rows)
    bs = config.bin_size
    y = (torch.arange(config.hash_volume, device=be.device)
         // config.hash_length) % config.hash_height
    keep = (y >= row0 // bs) & (y < -(-(row0 + n_rows) // bs))
    return be[:, keep], cnt[:, keep]


def check_trace(tag: str, ds, be, cnt, players, config, rows=None):
    """``trace.cu`` (over window ``rows``) against ``trace.trace_winner``
    on the card; raises on a difference.  Returns ``(max_abs_err, ms,
    plain_ms, bytes, operations)``, the bound's bytes those of the
    window's bin columns."""
    args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, players,
            config)
    work = {}
    (best_p, win_p), plain_ms = timed(
        lambda: trace.trace_winner(*args, work=work, rows=rows))
    best_k, win_k = trace_cuda.trace_winners(*args, with_best=True,
                                             rows=rows)
    require_equal(tag, "trace kernel winner", win_k, win_p)
    require_equal(tag, "trace kernel best", best_k, best_p)
    ms = cuda_ms(lambda: trace_cuda.trace_winners(*args, rows=rows),
                 KERNEL_REPS)
    be_w, cnt_w = window_tables(be, cnt, config, rows)
    n_bytes = (entity_bytes(be_w, cnt_w, ds.pos, ds.ext, ds.sprite_id)
               + nbytes(ds.atlas_depth, be_w, cnt_w, players, win_k))
    return (max(max_abs_err(win_k, win_p), max_abs_err(best_k, best_p)),
            ms, plain_ms, n_bytes,
            DEPTH_KEY_OPS * int(work["candidate_hits"]))


def check_shadow(tag: str, sargs, max_steps=None, rows=None):
    """The point mode of ``shadow.cu`` (under ``max_steps``, over window
    ``rows``) on ``shadow_cuda.trace_light``'s arguments ``sargs`` against
    ``shadow.trace_light_dynamic``; raises on a difference.  Returns
    ``(max_abs_err, ms, plain_ms, bytes, operations, lit)``."""
    work = {}
    lit_p, plain_ms = timed(lambda: shadow.trace_light_dynamic(
        *sargs, work=work, max_steps=max_steps))
    lit_k = shadow_cuda.trace_light(*sargs, max_steps=max_steps, rows=rows)
    require_equal(tag, "shadow kernel lit", lit_k, lit_p)
    ms = cuda_ms(lambda: shadow_cuda.trace_light(*sargs, max_steps=max_steps,
                                                 rows=rows), KERNEL_REPS)
    pos, ext, be, cnt, rb, lb, ent, origin, inv, players, _ = sargs
    light_bin = torch.stack([b.reshape(players.shape[0]) for b in lb], dim=1)
    n_bytes = (entity_bytes(be, cnt, pos, ext)
               + nbytes(players, be, cnt, *rb, *origin, *inv, ent, light_bin,
                        lit_k))
    return (max_abs_err(lit_k, lit_p), ms, plain_ms, n_bytes,
            SLAB_OPS * int(work["slab_tests"]), lit_k)


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the trace and point-mode shadow wrappers run their
    plain versions on CUDA tensors too (and count no launch): for the
    comparison of a whole path with its plain self, never for a run that
    is checked for launches."""
    saved = trace_cuda.trace_winners, shadow_cuda.trace_light

    def trace_plain(*args, with_best=False, rows=None):
        best, winner = trace.trace_winner(*args, rows=rows)
        return (best, winner) if with_best else winner

    def shadow_plain(*args, max_steps=None, rows=None):
        return shadow.trace_light_dynamic(*args, max_steps=max_steps)

    trace_cuda.trace_winners, shadow_cuda.trace_light = (trace_plain,
                                                         shadow_plain)
    try:
        yield
    finally:
        trace_cuda.trace_winners, shadow_cuda.trace_light = saved


def soft_frame_and_grad(fitter, ds, targets, at):
    """``(frame, grad)``: ``fitter.soft_frame`` at light ``at`` and the
    gradient of ``batch_loss`` over ``targets`` there."""
    light = torch.tensor(at, dtype=torch.float32, device=ds.device,
                         requires_grad=True)
    with torch.no_grad():
        frame = fitter.soft_frame(ds, light)
    fitter.batch_loss(light, ds, targets).backward()
    return frame, light.grad


def inverse_kernels(card: str, ds, fitter, light, launches) -> list[dict]:
    """The inverse path's kernels on one step's inputs at ``light``:
    ``trace.cu`` and the capped point mode of ``shadow.cu`` against their
    plain versions; the reciprocal directions at the start light (where
    t == 0 on pixel column 20) on the card against the CPU's, bit for bit
    with the signs of the infinities.  Returns the JSON rows."""
    r, cfg = fitter.renderer, fitter.config
    tag = "inverse"
    be, cnt = r.build_bins(ds)
    what = f"one {cfg.view_width}x{cfg.view_height} frame"
    trace_err, *trace_t = check_trace(tag, ds, be[None], cnt[None],
                                      ds.pos[:1], cfg)
    with torch.no_grad():
        gbuf = r.trace(ds, be, cnt)
        sargs = fitter.shadow_inputs(
            ds, be, cnt, gbuf, light,
            fitter.towards_light(gbuf.y, gbuf.z, light))
        cap = r.shadow_max_steps
        shadow_err, *shadow_t, lit = check_shadow(tag, sargs, cap)
        exact = shadow_cuda.trace_light(*sargs)
        start = torch.tensor(INVERSE_START, device=ds.device)
        tl = fitter.towards_light(gbuf.y, gbuf.z, start)
        inv = fitter.shadow_inputs(ds, be, cnt, gbuf, start, tl)[8]
        tl_cpu = fitter.towards_light(gbuf.y.cpu(), gbuf.z.cpu(),
                                      start.cpu())
    zeros = sum(int((t == 0).sum()) for t in tl_cpu)
    for a, (got, t) in enumerate(zip(inv, tl_cpu)):
        require_equal(tag, f"1 / t[{a}] at {INVERSE_START}, card vs CPU",
                      got[0].cpu().view(torch.int32),
                      torch.reciprocal(t).view(torch.int32))
    if zeros == 0:
        raise RuntimeError(f"{tag}: no t == 0 at {INVERSE_START}")
    print(f"{tag}: the cap of {cap} steps changes {int((lit != exact).sum())}"
          f" pixels' lit bit against the exact march at the fitted light; "
          f"1 / t on the card == the CPU's at {INVERSE_START} ({zeros} zero "
          f"components, their infinities signed as the zeros)")
    return [kernel_row("trace (inverse)", "trace", launches["trace"],
                       trace_err, *trace_t, what, card),
            kernel_row(f"shadow, capped at {cap} (inverse)", "shadow",
                       launches["shadow"], shadow_err, *shadow_t, what,
                       card)]


def inverse_phase(card: str, ds, renderer, anim, center) -> list[dict]:
    """``InverseLightFitter`` on graybox: 25 Adam steps toward the center
    orbit's first 8 frames, for each of INVERSE_RUNS, each run with the
    launch counts set to 0 just before and read just after (trace 1 and
    binning 2 a step, shadow 1 a step with shadows).  Raises unless the loss decreases
    (or, from a start whose gradient is exactly 0, stays), ``soft_frame``
    and the gradient with the kernels equal the same with the plain
    versions on the card (the frame bit for bit, the gradient to rtol
    1e-6: its sums reduce on the card in an order the two runs share, so
    they are expected equal) at the start and the fitted light, and the
    kernels equal their plain versions on the lit run's inputs.  Prints
    ms per step (host clock around each step, the card synchronised; the
    median) and the loss and light at steps 0 and 25.  Returns the
    kernels' JSON rows."""
    cfg = renderer.config
    players, lights = (t[:INVERSE_TARGETS] for t in center)
    frames = anim.render_states(ds, players, lights)
    targets = frames.to(torch.float32) / torch.tensor(255.0,
                                                      device=frames.device)
    rows = []
    for label, shadows, start in INVERSE_RUNS:
        tag = f"inverse, {label}"
        fitter = InverseLightFitter(cfg, renderer, INVERSE_LR, shadows)
        light, opt = fitter.init(start, device=ds.device)
        with torch.no_grad():
            loss0 = float(fitter.batch_loss(light, ds, targets))
        reset_launches()
        step_ms = []
        for _ in range(INVERSE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            light, opt, _ = fitter.train_step(light, opt, ds, targets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launches_are(
            f"{tag}, {INVERSE_STEPS} steps",
            {"trace": INVERSE_STEPS, "shadow": INVERSE_STEPS * shadows,
             "binning": 2 * INVERSE_STEPS})
        fitted = light.detach()
        with torch.no_grad():
            loss_n = float(fitter.batch_loss(fitted, ds, targets))
        print(f"{tag}: {INVERSE_STEPS} Adam steps at lr {INVERSE_LR} on "
              f"{INVERSE_TARGETS} graybox targets, {np.median(step_ms):.2f} "
              f"ms/step (median; step 1 {step_ms[0]:.2f} ms); step 0 "
              f"loss {loss0:.8f} at light {list(start)}, step "
              f"{INVERSE_STEPS} loss {loss_n:.8f} at light "
              f"{fitted.tolist()}  [{card}]")
        grad0 = None
        for at in (start, tuple(fitted.tolist())):
            frame_k, grad_k = soft_frame_and_grad(fitter, ds, targets, at)
            with plain_kernels():
                frame_p, grad_p = soft_frame_and_grad(fitter, ds, targets,
                                                      at)
            require_equal(tag, f"soft_frame at {at} with the kernels vs "
                          f"the plain versions", frame_k.view(torch.int32),
                          frame_p.view(torch.int32))
            if not torch.allclose(grad_k, grad_p, rtol=1e-6, atol=0.0):
                raise RuntimeError(f"{tag}: the gradient at {at} is "
                                   f"{grad_k.tolist()} with the kernels, "
                                   f"{grad_p.tolist()} with the plain "
                                   f"versions")
            grad0 = grad_k if grad0 is None else grad0
        stuck = not bool(grad0.any())
        if not (loss_n < loss0 or (stuck and loss_n == loss0)):
            raise RuntimeError(f"{tag}: the loss went from {loss0} to "
                               f"{loss_n}, the gradient at the start "
                               f"{grad0.tolist()}")
        print(f"{tag}: soft_frame == the plain versions' bit for bit, "
              f"gradient within rtol 1e-6, at the start and the fitted "
              f"light; gradient at the start {grad0.tolist()}"
              + ("; exactly 0, so the light stays" if stuck else ""))
        if start == INVERSE_LIT_START:
            rows += inverse_kernels(card, ds, fitter, fitted, launches)
    return rows


def entity_scene():
    """``(scene, config)`` of the entity-sharded render (ENTITY_SIDE)."""
    config = dataclasses.replace(DEFAULT_CONFIG, early_exit=False)
    scene = demo_world(ENTITY_SIDE, config)
    if scene.n_entities % PARALLEL_RANKS:
        pad = PARALLEL_RANKS - scene.n_entities % PARALLEL_RANKS
        scene = dataclasses.replace(
            scene,
            pos=np.concatenate([scene.pos, np.full((pad, 3), -1000,
                                                   np.int32)]),
            ext=np.concatenate([scene.ext, np.full((pad, 3), 20, np.int32)]),
            sprite_id=np.concatenate([scene.sprite_id,
                                      np.zeros(pad, np.int32)]))
    return scene, config


def collective_ms(fn, reps: int) -> float:
    """Mean milliseconds of a call of ``fn`` on every rank: one warm-up,
    then ``reps`` calls between two barriers of the synchronised card."""
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) * 1e3 / reps


def parallel_rank(device, scene, escene, players, lights, targets):
    """One rank of ``parallel_phase``: each sharded path once with the
    launch counts set to 0 just before and read just after, then timed.
    Returns ``{path: (result, launches, ms)}``."""
    cfg = DEFAULT_CONFIG
    renderer = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans,
                       device=device)
    anim = AnimationRenderer(renderer, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg, device=device)
    players, lights, targets = (t.to(device) for t in (players, lights,
                                                      targets))
    out = {}
    for name, fp in MESHES.items():
        mesh = make_mesh(frame_parallel=fp)

        def render():
            return render_frames_sharded(anim, ds, players, lights, mesh)

        reset_launches()
        frames = render()
        torch.cuda.synchronize()
        out[f"render, {name}"] = (frames.cpu(), read_launches(),
                                  collective_ms(render, PARALLEL_REPS))
    fitter = InverseLightFitter(cfg, renderer, INVERSE_LR, True)
    for name, fp in MESHES.items():
        mesh = make_mesh(frame_parallel=fp)
        light, opt = fitter.init(INVERSE_LIT_START, device=device)
        reset_launches()
        light, opt, loss = sharded_train_step(fitter, light, opt, ds,
                                              targets, mesh)
        torch.cuda.synchronize()
        result = (light.detach().cpu().clone(), float(loss),
                  light.grad.cpu().clone())
        launches = read_launches()
        out[f"train step, {name}"] = (result, launches, collective_ms(
            lambda: sharded_train_step(fitter, light, opt, ds, targets,
                                       mesh), PARALLEL_REPS))
    ecfg = dataclasses.replace(cfg, early_exit=False)
    er = DeferredRenderer(ecfg).configure_for(escene)
    eds = DeviceScene.from_scene(escene, ecfg, device=device)
    light = default_light(ecfg).as_array()

    def entity():
        return render_frame_entity_sharded(er, eds, light,
                                           make_entity_mesh())

    reset_launches()
    frame = entity()
    torch.cuda.synchronize()
    out["entity-sharded render"] = (frame.cpu(), read_launches(),
                                    collective_ms(entity, PARALLEL_REPS))
    return out


def parallel_phase(card: str, scene, ds, renderer, anim,
                   center) -> list[dict]:
    """``parallel/`` over PARALLEL_RANKS processes sharing the card over
    gloo (``launch.run_ranks``; the kernels were built before they
    start): the frame x row render of 8 graybox frames on both meshes, one
    ``sharded_train_step`` (with shadows, from INVERSE_LIT_START, where no
    component of the gradient is 0) on both, and the entity-sharded
    render of ENTITY_SIDE's scene.  Raises unless every rank's frames equal
    ``render_states``', its step's loss is within 1e-6 and the gradient it
    applied (summed over the ranks) and its light within rtol 1e-5 of
    ``train_step``'s, its entity-sharded frame equals
    the unsharded render, and every rank launched trace 1 + shadow 1 in
    each run, and binning 2 where it rebins (the train step and the
    entity-sharded render).  Then the windowed and the shard kernels against their plain
    versions on the card, on each rank's inputs.  Prints ms per call
    (a functional check on one card, not a scaling measurement).  Returns
    the kernels' JSON rows."""
    cfg = renderer.config
    players, lights = (t[:PARALLEL_FRAMES] for t in center)
    frames = anim.render_states(ds, players, lights)
    targets = frames.to(torch.float32) / torch.tensor(255.0,
                                                      device=frames.device)
    fitter = InverseLightFitter(cfg, renderer, INVERSE_LR, True)
    light, opt = fitter.init(INVERSE_LIT_START, device=ds.device)
    light, _, loss = fitter.train_step(light, opt, ds, targets)
    grad = light.grad.cpu()
    if not bool(grad.all()):
        raise RuntimeError(f"parallel: train_step's gradient at "
                           f"{INVERSE_LIT_START} is {grad.tolist()}: a 0 "
                           f"component cannot show the ranks' exchange")
    escene, ecfg = entity_scene()
    er = DeferredRenderer(ecfg).configure_for(escene)
    eds = DeviceScene.from_scene(escene, ecfg)
    elight = default_light(ecfg).as_array()
    eframe = er.render(eds, elight)
    t0 = time.perf_counter()
    results = run_ranks(parallel_rank, PARALLEL_RANKS,
                        (scene, escene, players.cpu(), lights.cpu(),
                         targets.cpu()), device="cuda")
    print(f"parallel: {PARALLEL_RANKS} ranks sharing the card over gloo, "
          f"{time.perf_counter() - t0:.1f} s with their start-up; a "
          f"functional check on one card, not a scaling measurement")
    launched = {}
    for path in results[0]:
        note = ""
        # The frame x row render bins on the StaticBins cache; the train
        # step and the entity-sharded render rebin on the binning kernel.
        want = {"trace": 1, "shadow": 1,
                **({} if path.startswith("render") else {"binning": 2})}
        for rank, res in enumerate(results):
            got, launches, _ = res[path]
            launches = {k: v for k, v in launches.items() if v}
            if launches != want:
                raise RuntimeError(f"{path}, rank {rank}: launches "
                                   f"{launches}, expected {want}")
            if path.startswith("render"):
                require_equal(path, f"rank {rank}'s frames vs render_states",
                              got, frames.cpu())
            elif path.startswith("train"):
                light_r, loss_r, grad_r = got
                if not (abs(loss_r - float(loss)) < 1e-6
                        and torch.allclose(grad_r, grad, rtol=1e-5, atol=0)
                        and torch.allclose(light_r, light.detach().cpu(),
                                           rtol=1e-5, atol=0)):
                    raise RuntimeError(
                        f"{path}, rank {rank}: light {light_r.tolist()}, "
                        f"loss {loss_r}, gradient {grad_r.tolist()}; "
                        f"train_step's {light.detach().tolist()}, "
                        f"{float(loss)}, {grad.tolist()}")
                rel = float(((grad_r - grad).abs() / grad.abs()).max())
                note = (f"; gradient {grad_r.tolist()}, at most {rel:.3g} "
                        f"from train_step's (relative)")
            else:
                require_equal(path, f"rank {rank}'s frame vs the unsharded "
                              f"render", got, eframe.cpu())
        launched[path] = sum(res[path][1]["trace"] for res in results)
        ms = max(res[path][2] for res in results)
        print(f"{path}: every rank == the single process, trace 1 + shadow "
              f"1 launches a rank; {ms:.2f} ms per call{note}  [{card}]")

    # The kernels on the ranks' inputs, here in one process.
    rows = []
    be, cnt = batched.bin_stage(renderer, anim.static_bins, ds, players)
    n_rows = cfg.view_height // PARALLEL_RANKS
    windows = [(k * n_rows, n_rows) for k in range(PARALLEL_RANKS)]
    checks = []
    for rows_w in windows:
        tag = f"row window {rows_w}"
        t = check_trace(tag, ds, be, cnt, players, cfg, rows_w)
        gbuf = batched.trace_stage(renderer, ds, be, cnt, players, rows_w)
        _, inv, origin, rb, lb = batched.geometry_stage(renderer, gbuf,
                                                        lights)
        s = check_shadow(tag, (ds.pos, ds.ext, be, cnt, rb, lb,
                               gbuf.entity_index, origin, inv, players, cfg),
                         rows=rows_w)
        checks.append((t, s[:-1]))
    what = (f"F={PARALLEL_FRAMES} frames of rows {windows[0][0]}.."
            f"{sum(windows[0]) - 1} (every window bit-exact)")
    n = launched["render, frames 1 x rows 2"]
    rows.append(kernel_row("trace (row window)", "trace", n, *checks[0][0],
                           what, card))
    rows.append(kernel_row("shadow (row window)", "shadow", n,
                           *checks[0][1], what, card))

    Np = escene.n_entities // PARALLEL_RANKS
    gbuf = er.trace(eds, *er.build_bins(eds))
    lights_e = torch.as_tensor(elight, dtype=torch.int32,
                               device=eds.device)[None]
    checks = []
    for k in range(PARALLEL_RANKS):
        shard = slice(k * Np, (k + 1) * Np)
        ds_k = dataclasses.replace(eds, pos=eds.pos[shard],
                                   ext=eds.ext[shard],
                                   sprite_id=eds.sprite_id[shard])
        be_k, cnt_k = binning.build_bins(ds_k.pos, ds_k.ext, ecfg, er.spans)
        be_k, cnt_k = be_k[None], cnt_k[None]
        tag = f"entity shard {k}"
        t = check_trace(tag, ds_k, be_k, cnt_k, ds_k.pos[:1], ecfg)
        g = GBufferArrays(*(f[None] for f in gbuf))
        _, inv, origin, rb, lb = shade.light_geometry(g, lights_e, ecfg)
        s = check_shadow(tag, (ds_k.pos, ds_k.ext, be_k, cnt_k, rb, lb,
                               g.entity_index - k * Np, origin, inv,
                               ds_k.pos[:1], ecfg))
        checks.append((t, s[:-1]))
    what = (f"shard 0 of {escene.n_entities} entities, one "
            f"{ecfg.view_width}x{ecfg.view_height} frame (every shard "
            f"bit-exact)")
    n = launched["entity-sharded render"]
    rows.append(kernel_row("trace (entity shard)", "trace", n,
                           *checks[0][0], what, card))
    rows.append(kernel_row("shadow (entity shard)", "shadow", n,
                           *checks[0][1], what, card))
    return rows


def run_phases(names=("inverse", "parallel")) -> None:
    """The inverse and sharded phases alone on graybox (for a quick check
    on the card): ``python3 -c "import chip_smoke as cs;
    cs.run_phases()"``.  Builds the kernels, the graybox scene, its cache
    and the center orbit, runs the named phases and prints their kernels'
    JSON line."""
    card = require_card()
    kernels.library()
    cfg = DEFAULT_CONFIG
    scene = graybox_world(cfg)
    renderer = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans)
    anim = AnimationRenderer(renderer, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg)
    light = default_light(cfg)
    center = anim.light_sweep_states(FRAMES, scene.pos[0],
                                     center=(light.x, light.y, light.z),
                                     radius=40)
    phases = {"inverse": lambda: inverse_phase(card, ds, renderer, anim,
                                               center),
              "parallel": lambda: parallel_phase(card, scene, ds, renderer,
                                                 anim, center)}
    rows = [row for name in names for row in phases[name]()]
    print(json.dumps({"kernels": rows}))


def require_card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``device.card``), printed with the device; raises without a CUDA
    device."""
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    return card


def main() -> int:
    cfg = DEFAULT_CONFIG

    # -- 1. the card ---------------------------------------------------------
    card = require_card()

    # -- 2. build the kernels and the C++ oracle -----------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({kernels.build_dir().name})")
    t0 = time.perf_counter()
    native.library()
    print(f"oracle build: {time.perf_counter() - t0:.2f} s "
          f"({native.build_dir().name})")

    # -- 3. scene, caches and the three bench orbits -------------------------
    t0 = time.perf_counter()
    scene = graybox_world(cfg)
    renderer = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans)
    anim = AnimationRenderer(renderer, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg)
    light = default_light(cfg)
    orbits = {
        "center": (light.x, light.y, light.z),
        "edge_x": (20, light.y, light.z),
        "edge_z": (light.x, light.y, 280),
    }
    sweeps = {name: anim.light_sweep_states(FRAMES, scene.pos[0], center=c,
                                            radius=40)
              for name, c in orbits.items()}
    torch.cuda.synchronize()
    print(f"setup: {scene.n_entities} entities, spans {renderer.spans}, "
          f"{time.perf_counter() - t0:.2f} s")
    for k, occ, threads in (
            ("trace", trace_cuda.occupancy(cfg),
             trace_cuda.block_threads(cfg)),
            ("shadow", shadow_cuda.occupancy(cfg),
             shadow_cuda.march_threads(cfg)),
            ("fused", fused_cuda.occupancy(cfg),
             fused_cuda.block_threads(cfg))):
        smem, blocks, regs, local = occ
        print(f"{k} kernel: {smem} B of shared memory per block, {blocks} "
              f"blocks per SM at {threads} threads, {regs} registers and "
              f"{local} B of local memory a thread  [{card}]")
    shade_grid("graybox", cfg, FRAMES, card)
    H, W = cfg.view_height, cfg.view_width
    n_pix = FRAMES * H * W

    # -- 4. each kernel against its plain version, at the main paths' shapes -
    errs = dict.fromkeys(SOURCES, 0)
    times = {k: [] for name in SOURCES for k in (name, name + "_plain")}
    bounds = {name: [] for name in SOURCES}  # (bytes, operations) per orbit
    test_ops = {"trace": [], "fused": []}  # every candidate test counted
    every_probe_ops = {"shadow": [], "fused": []}  # repeats counted
    for name, (players, lights) in sweeps.items():
        be, cnt = batched.bin_stage(renderer, cache, ds, players)
        args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt,
                players, cfg)

        # Kernel 3 (fused) first: its plain run also counts the work.
        fargs = args[:-1] + (lights, cfg)
        work = {}
        best_p, win_p, lit_p = fused.trace_shadow(*fargs, work=work)
        fused_cuda.counters.reset()
        best_k, win_k, lit_k = fused_cuda.trace_shadow(*fargs,
                                                       with_best=True)
        fused_stats = fused_cuda.counters.read()
        for what, got, want in (("winner", win_k, win_p),
                                ("best", best_k, best_p),
                                ("lit", lit_k, lit_p)):
            require_equal(name, f"fused kernel {what}", got, want)
        errs["fused"] = max(errs["fused"], max_abs_err(win_k, win_p),
                            max_abs_err(best_k, best_p),
                            max_abs_err(lit_k, lit_p))
        times["fused"].append(cuda_ms(
            lambda: fused_cuda.trace_shadow(*fargs), KERNEL_REPS))
        times["fused_plain"].append(cuda_ms(
            lambda: fused.trace_shadow(*fargs), PLAIN_REPS, warm_up=False))
        key_ops = DEPTH_KEY_OPS * int(work["candidate_hits"])
        shadow_ops = SLAB_OPS * int(work["slab_tests"])
        rows_b = entity_bytes(be, cnt, ds.pos, ds.ext, ds.sprite_id)
        bounds["fused"].append((rows_b + nbytes(ds.atlas_depth, be, cnt,
                                                players, lights, win_k,
                                                lit_k),
                                key_ops + shadow_ops))
        tests = TRACE_OPS_PER_CANDIDATE * int(work["candidate_tests"])
        test_ops["fused"].append(tests + shadow_ops)
        test_ops["trace"].append(tests)
        old_ops = SLAB_OPS * int(work["slab_tests_every_probe"])
        every_probe_ops["fused"].append(key_ops + old_ops)
        every_probe_ops["shadow"].append(old_ops)

        # Kernel 1 (trace).
        best_k, win_k = trace_cuda.trace_winners(*args, with_best=True)
        require_equal(name, "trace kernel winner", win_k, win_p)
        require_equal(name, "trace kernel best", best_k, best_p)
        best_t, win_t = trace.trace_winner(*args)
        require_equal(name, "trace_winner winner", win_t, win_p)
        require_equal(name, "trace_winner best", best_t, best_p)
        errs["trace"] = max(errs["trace"], max_abs_err(win_k, win_t),
                            max_abs_err(best_k, best_t))
        times["trace"].append(cuda_ms(lambda: trace_cuda.trace_winners(*args),
                                      KERNEL_REPS))
        times["trace_plain"].append(cuda_ms(lambda: trace.trace_winner(*args),
                                            PLAIN_REPS, warm_up=False))
        bounds["trace"].append((rows_b + nbytes(ds.atlas_depth, be, cnt,
                                                players, win_k),
                                key_ops))

        # Kernel 2 (shadow), on the G-buffer of kernel 1's winners.
        gbuf = trace.materialize_gbuffer(
            win_k, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, players, cfg)
        _, inv, origin, rb, lb = batched.geometry_stage(renderer, gbuf,
                                                        lights)
        sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
                 inv, players, cfg)
        shadow_cuda.counters.reset()
        lit_k = shadow_cuda.trace_light(*sargs)
        longest = longest_visit_list(rb, lb, cfg)
        list_path(name, "fused kernel", fused_stats, n_pix, longest)
        list_path(name, "shadow kernel", shadow_cuda.counters.read(), n_pix,
                  longest)
        lit_s = shadow.trace_light_dynamic(*sargs)
        require_equal(name, "shadow kernel lit", lit_k, lit_s)
        require_equal(name, "trace_light_dynamic lit", lit_s, lit_p)
        errs["shadow"] = max(errs["shadow"], max_abs_err(lit_k, lit_s))
        times["shadow"].append(cuda_ms(lambda: shadow_cuda.trace_light(*sargs),
                                       KERNEL_REPS))
        times["shadow_plain"].append(
            cuda_ms(lambda: shadow.trace_light_dynamic(*sargs), PLAIN_REPS,
                    warm_up=False))
        light_bin = torch.stack([b.reshape(FRAMES) for b in lb], dim=1)
        bounds["shadow"].append((
            entity_bytes(be, cnt, ds.pos, ds.ext)
            + nbytes(players, be, cnt, *rb, *origin, *inv,
                     gbuf.entity_index, light_bin, lit_k), shadow_ops))

        # Kernel 2's winner-input point mode, on kernel 1's winners: the
        # frames against the plain chain, the lit mask against the march's.
        wargs = (win_k, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
                 ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt,
                 players, lights, cfg)
        shadow_cuda.counters.reset()
        frames_k = shadow_cuda.shade_point(*wargs)
        list_path(name, "shadow kernel (winner inputs)",
                  shadow_cuda.counters.read(), n_pix, longest)
        frames_p = shade.point_frames(*wargs)
        require_equal(name, "winner-input kernel frames", frames_k, frames_p)
        require_equal(name, "point_frames vs the G-buffer chain's frames",
                      frames_p, batched.shade_stage(
                          renderer, ds, gbuf, shade.factor_from_dot(
                              batched.geometry_stage(renderer, gbuf,
                                                     lights)[0],
                              lit_s, cfg)))
        lit_w = shadow_cuda.shade_point(*wargs, frames=False)
        require_equal(name, "winner-input kernel lit", lit_w, lit_s)
        errs["shadow_shade"] = max(errs["shadow_shade"],
                                   max_abs_err(frames_k, frames_p),
                                   max_abs_err(lit_w, lit_s))
        times["shadow_shade"].append(cuda_ms(
            lambda: shadow_cuda.shade_point(*wargs), KERNEL_REPS))
        times["shadow_shade_plain"].append(cuda_ms(
            lambda: shade.point_frames(*wargs), PLAIN_REPS, warm_up=False))
        bounds["shadow_shade"].append((
            rows_b + nbytes(players, lights, be, cnt, win_k, ds.atlas_depth,
                            ds.atlas_color, ds.atlas_normal, ds.palette,
                            frames_k),
            shadow_ops + SHADE_OPS * n_pix))
        print(f"{name}: F={FRAMES} kernels == plain versions (trace winners "
              f"and best depth, shadow lit mask, winner-input frames and lit "
              f"mask, fused winners, best depth "
              f"and lit mask), bit-exact; {int(work['candidate_tests'])} "
              f"candidate tests, {int(work['candidate_hits'])} candidate "
              f"hits, {int(work['slab_tests'])} slab tests needed "
              f"({int(work['slab_tests_every_probe'])} at every probe), "
              f"{rows_b} B of entity rows named by the bins")

    # -- 5. the two-kernel main path -----------------------------------------
    reset_launches()
    shadow_cuda.counters.reset()
    with glue_calls() as glue:
        frames = {name: anim.render_states(ds, players, lights)
                  for name, (players, lights) in sweeps.items()}
    launches = launches_are("two-kernel path, 3 batches",
                            {"trace": len(sweeps),
                             "shadow_shade": len(sweeps)})
    print(f"two-kernel path: G-buffer and light-geometry calls {glue}")
    if any(glue.values()):
        raise RuntimeError(f"the two-kernel path called the G-buffer chain: "
                           f"{glue}")
    list_path("two-kernel path", "shadow kernel (winner inputs)",
              shadow_cuda.counters.read(), launches["shadow_shade"] * n_pix)

    # -- 6. the fused main path ----------------------------------------------
    renderer.fuse_trace_shadow = True
    reset_launches()
    fused_cuda.counters.reset()
    frames_fused = {name: anim.render_states(ds, players, lights)
                    for name, (players, lights) in sweeps.items()}
    torch.cuda.synchronize()
    launches["fused"] = fused_cuda.launches
    print(f"fused path launches: fused {fused_cuda.launches}, trace "
          f"{trace_cuda.launches}, shadow {shadow_cuda.launches}")
    if launches["fused"] == 0:
        raise RuntimeError("the fused path never launched the fused kernel")
    list_path("fused path", "fused kernel", fused_cuda.counters.read(),
              launches["fused"] * n_pix)
    for name in sweeps:
        require_equal(name, "fused-path frames vs two-kernel frames",
                      frames_fused[name], frames[name])
    print("fused-path frames == two-kernel frames, all 3 orbits x "
          f"{FRAMES} frames")

    # -- 7. end-to-end times and stage splits --------------------------------
    rays = 2 * W * H * FRAMES
    for name, (players, lights) in sweeps.items():
        ms = {}
        for fuse in (False, True, True, False):
            renderer.fuse_trace_shadow = fuse
            ms.setdefault(fuse, []).append(cuda_ms(
                lambda: anim.render_states(ds, players, lights), TIMED_REPS))
        for fuse, label in ((False, "two-kernel"), (True, "fused")):
            m = float(np.mean(ms[fuse]))
            print(f"{name} {label}: F={FRAMES} {m / FRAMES:.4f} ms/frame, "
                  f"{rays / (m * 1e3):.2f} Mrays/s  [{card}]")

    players, lights = sweeps["center"]

    two_kernel = gbuffer_stages(renderer, cache, ds, players, lights)

    def fused_kernel(s):
        _, s["win"], s["lit"] = fused_cuda.trace_shadow(
            ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, s["be"], s["cnt"],
            players, lights, cfg)

    def gbuf_geometry(s):
        s["gbuf"] = trace.materialize_gbuffer(
            s["win"], ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, players, cfg)
        s["dot"] = batched.geometry_stage(renderer, s["gbuf"], lights)[0]

    for label, stages in (
            ("two-kernel", main_path_stages(renderer, cache, ds, players,
                                            lights)),
            ("G-buffer mode", two_kernel),
            ("fused", [two_kernel[0], ("fused", fused_kernel),
                       ("gbuffer+geometry", gbuf_geometry), two_kernel[-1]])):
        split = ", ".join(f"{k} {v:.4f}"
                          for k, v in stage_split(stages, TIMED_REPS).items())
        print(f"center {label} stage split, ms/frame at F={FRAMES}: {split}"
              f"  [{card}]")

    # -- 8. parity against the C++ oracle ------------------------------------
    checks = [(name, 0) for name in sweeps] + [("edge_z", FRAMES // 2)]
    for name, f in checks:
        players, lights = sweeps[name]
        golden, _ = oracle_frame(scene, players[f].tolist(),
                                 lights[f].tolist(), cfg)
        for label, out in (("two-kernel", frames), ("fused", frames_fused)):
            bad = int((out[name][f].cpu().numpy() != golden).any(axis=-1)
                      .sum())
            if bad:
                raise RuntimeError(f"{label} {name} frame {f}: {bad} pixels "
                                   f"differ from cpp_render_frame")
        print(f"{name} frame {f}: both paths pixel-exact against "
              f"cpp_render_frame")

    # -- 9. the directional mode of the shadow kernel against its plain ------
    #       version, on the directional sweep
    home = sweeps["center"][0]  # the player at home in every frame
    dirs = direction_sweep(FRAMES, home.device)
    steps = shadow_dir.grid_max_steps(cfg)
    be, cnt = batched.bin_stage(renderer, cache, ds, home)
    gbuf = batched.trace_stage(renderer, ds, be, cnt, home)
    _, inv, K = shadow_dir.direction_constants(dirs, cfg)
    dargs = (ds.pos, ds.ext, be, cnt, gbuf.y, gbuf.z, gbuf.entity_index, inv,
             K, home, cfg, steps)
    work = {}
    lit_p = shadow_dir.trace_light_directional(*dargs, work=work)
    shadow_cuda.counters.reset()
    lit_k = shadow_cuda.trace_light_directional(*dargs)
    dir_stats = shadow_cuda.counters.read()
    require_equal("directional", "shadow kernel lit (directional mode)",
                  lit_k, lit_p)
    unions = shadow_dir.tile_unions(gbuf.y, gbuf.z, K, cfg, steps)
    list_path("directional sweep", "shadow kernel (directional mode)",
              dir_stats, n_pix, unions["longest"],
              keys=DIRECTIONAL_KEY_LABEL)
    direct_share = dir_stats["direct_pixels"] / n_pix
    print(f"directional sweep: {direct_share:.6f} of the pixels marched "
          f"directly (step cap {steps})")
    if direct_share >= DIRECT_SHARE:
        raise RuntimeError(f"directional sweep: {direct_share:.4f} of the "
                           f"pixels took the direct march")
    directional_unions(dir_stats, unions, work)
    errs["shadow_directional"] = max_abs_err(lit_k, lit_p)
    times["shadow_directional"] = [cuda_ms(
        lambda: shadow_cuda.trace_light_directional(*dargs), KERNEL_REPS)]
    times["shadow_directional_plain"] = [cuda_ms(
        lambda: shadow_dir.trace_light_directional(*dargs), PLAIN_REPS,
        warm_up=False)]
    near_far = int(work["slab_tests_finite"])
    bounds["shadow_directional"] = [(
        entity_bytes(be, cnt, ds.pos, ds.ext)
        + nbytes(home, be, cnt, gbuf.y, gbuf.z, gbuf.entity_index, inv, K,
                 lit_k),
        NEAR_FAR_OPS * near_far
        + SLAB_OPS * (int(work["slab_tests"]) - near_far))]
    smem, blocks, regs, local = shadow_cuda.directional_occupancy(cfg)
    print(f"shadow kernel (directional mode): {smem} B of shared memory per "
          f"block, {blocks} blocks per SM at "
          f"{shadow_cuda.march_threads(cfg)} threads, {regs} registers and "
          f"{local} B of local memory a thread; a table of "
          f"{shadow_dir.TABLE_KEYS} keys, a key mask and a union "
          f"entry per grid bin ({cfg.hash_volume})  [{card}]")
    print(f"directional sweep: F={FRAMES} directional kernel == "
          f"trace_light_directional, bit-exact; "
          f"{int(work['slab_tests'])} slab tests needed, {near_far} of "
          f"them in frames of a finite reciprocal direction "
          f"({NEAR_FAR_OPS} operations each, {SLAB_OPS} the others; "
          f"{int(work['slab_tests_every_probe'])} at every probe)")

    # -- 10. the lighting modes' main paths, one batch each ------------------
    center_players, center_lights = sweeps["center"]
    multi = torch.stack([sweeps[n][1] for n in ("center", "edge_x",
                                                 "edge_z")], dim=1)
    dithered = DeferredRenderer(cfg, style="dithered").configure_for(scene)
    anim_dithered = AnimationRenderer(dithered, cfg, static_bins=cache)
    none = dict.fromkeys(read_launches(), 0)
    two_kernel = {**none, "trace": 1, "shadow": 1}
    directional_only = {**none, "trace": 1, "shadow_directional": 1}
    paths = {}  # label -> (anim, players, lights, directional, frames)
    counts = {}  # label -> launches per batch
    for fuse in (False, True):
        renderer.fuse_trace_shadow = dithered.fuse_trace_shadow = fuse
        tag = "fused setting" if fuse else "two-kernel setting"
        for label, a, players, lights, directional, want in (
                ("multi-light", anim, home, multi, False,
                 {**none, "trace": 1, "shadow": 3}),
                ("directional", anim, home, dirs, True, directional_only),
                ("dithered point", anim_dithered, center_players,
                 center_lights, False,
                 {**none, "fused": 1} if fuse else two_kernel),
                ("dithered directional", anim_dithered, home, dirs, True,
                 directional_only)):
            shadow_cuda.counters.reset()
            frames_m, counts[f"{label}, {tag}"] = drive(
                f"{label}, {tag}", a, ds, players, lights, want,
                directional=directional)
            paths[f"{label}, {tag}"] = (a, players, lights, directional,
                                        frames_m)
            if label == "directional":
                list_path(f"directional, {tag}",
                          "shadow kernel (directional mode)",
                          shadow_cuda.counters.read(), n_pix,
                          keys=DIRECTIONAL_KEY_LABEL)
    mode_launches = counts["directional, two-kernel setting"]
    # The G-buffer point mode's launches: the multi-light path's, one a
    # light (the main path takes the winner-input mode).
    launches["shadow"] = counts["multi-light, two-kernel setting"]["shadow"]
    for label in ("multi-light", "directional", "dithered point",
                  "dithered directional"):
        require_equal(label, "fused-setting frames vs two-kernel frames",
                      paths[f"{label}, fused setting"][4],
                      paths[f"{label}, two-kernel setting"][4])
    palette = ds.palette[:, :3].long()
    for label in ("dithered point", "dithered directional"):
        frames_d = paths[f"{label}, two-kernel setting"][4].long()
        codes = (frames_d[..., 0] << 16) | (frames_d[..., 1] << 8) \
            | frames_d[..., 2]
        allowed = (palette[:, 0] << 16) | (palette[:, 1] << 8) | palette[:, 2]
        if not bool(torch.isin(codes, allowed).all()):
            raise RuntimeError(f"{label}: a frame holds a colour outside the "
                               f"palette")
    print("lighting modes: fused-setting frames == two-kernel frames on all "
          f"4 paths x {FRAMES} frames; dithered frames hold palette colours "
          "only")

    # -- 11. frames 0 and 32 of every new path against the CPU ---------------
    renderer.fuse_trace_shadow = dithered.fuse_trace_shadow = False
    ds_cpu = DeviceScene.from_scene(scene, cfg, device="cpu")
    cache_cpu = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans,
                           device="cpu")
    pick = [0, FRAMES // 2]
    for label in ("multi-light", "directional", "dithered point",
                  "dithered directional"):
        a, players, lights, directional, frames = paths[
            f"{label}, two-kernel setting"]
        a_cpu = AnimationRenderer(a.renderer, cfg, static_bins=cache_cpu)
        want = a_cpu.render_states(ds_cpu, players[pick].cpu(),
                                   lights[pick].cpu(),
                                   directional=directional)
        require_equal(label, "frames 0 and 32 vs the CPU", frames[pick].cpu(),
                      want)
        print(f"{label}: frames 0 and {FRAMES // 2} == the CPU's plain "
              f"versions")

    # -- 12. the new paths' times and stage splits ---------------------------
    for label, L in (("multi-light", 3), ("directional", 1),
                     ("dithered point", 1), ("dithered directional", 1)):
        ms = {}
        for fuse in (False, True, True, False):
            renderer.fuse_trace_shadow = dithered.fuse_trace_shadow = fuse
            tag = "fused setting" if fuse else "two-kernel setting"
            a, players, lights, directional, _ = paths[f"{label}, {tag}"]
            ms.setdefault(tag, []).append(cuda_ms(
                lambda: a.render_states(ds, players, lights,
                                        directional=directional),
                TIMED_REPS))
        new_rays = (1 + L) * W * H * FRAMES
        for tag, v in ms.items():
            m = float(np.mean(v))
            print(f"{label}, {tag}: F={FRAMES} {m / FRAMES:.4f} ms/frame, "
                  f"{new_rays / (m * 1e3):.2f} Mrays/s ({1 + L} rays a "
                  f"pixel)  [{card}]")
    renderer.fuse_trace_shadow = dithered.fuse_trace_shadow = False

    def trace_home(s):
        s["be"], s["cnt"] = batched.bin_stage(renderer, cache, ds, home)
        s["gbuf"] = batched.trace_stage(renderer, ds, s["be"], s["cnt"],
                                        home)

    def directional_lit(s):
        s["dot"], s["lit"] = batched.directional_stage(
            renderer, ds, s["be"], s["cnt"], home, s["gbuf"], dirs)

    def multi_factor(s):
        s["factor"] = batched.multi_light_stage(
            renderer, ds, s["be"], s["cnt"], home, s["gbuf"], multi)

    def factor(s):
        s["factor"] = shade.factor_from_dot(s["dot"], s["lit"], cfg)

    def shade_reference(s):
        batched.shade_stage(renderer, ds, s["gbuf"], s["factor"])

    def shade_dithered(s):
        batched.shade_stage(dithered, ds, s["gbuf"], s["factor"])

    for label, stages in (
            ("multi-light", [("bins+trace+gbuffer", trace_home),
                             ("3 x (geometry+shadow)+factor", multi_factor),
                             ("shade", shade_reference)]),
            ("dithered directional", [
                ("bins+trace+gbuffer", trace_home),
                ("directional (dot+kernel)", directional_lit),
                ("factor", factor), ("dither", shade_dithered)])):
        split = ", ".join(f"{k} {v:.4f}"
                          for k, v in stage_split(stages, TIMED_REPS).items())
        print(f"{label} stage split, ms/frame at F={FRAMES}: {split}"
              f"  [{card}]")

    # -- 13. kernel times beside their plain versions and bounds -------------
    mean = {k: float(np.mean(v)) for k, v in times.items()}
    rows = []
    for k, (src, rep) in SOURCES.items():
        bound_ms, bound_by = bound(*np.mean(bounds[k], axis=0))
        print(f"{k} kernel {mean[k]:.4f} ms, plain {mean[k + '_plain']:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{mean[k] / bound_ms:.1f}x) per call on F={FRAMES} {W}x{H} "
              f"frames (mean of 3 orbits; "
              + " / ".join(f"{o} {t:.4f}" for o, t in zip(sweeps, times[k]))
              + f" ms)  [{card}]")
        if k in test_ops:
            old_ms, old_by = bound(np.mean(bounds[k], axis=0)[0],
                                   np.mean(test_ops[k]))
            print(f"{k} kernel bound with the walk counted at every "
                  f"candidate test: {old_ms:.4f} ms ({old_by}, "
                  f"{mean[k] / old_ms:.1f}x)")
        if k in every_probe_ops:
            old_ms, old_by = bound(np.mean(bounds[k], axis=0)[0],
                                   np.mean(every_probe_ops[k]))
            print(f"{k} kernel bound with slab tests counted at every "
                  f"probe: {old_ms:.4f} ms ({old_by}, "
                  f"{mean[k] / old_ms:.1f}x)")
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k],
                     "max_abs_err": errs[k], "ms": mean[k],
                     "plain_ms": mean[k + "_plain"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    k = "shadow_directional"
    bound_ms, bound_by = bound(*bounds[k][0])
    print(f"{k} kernel {mean[k]:.4f} ms, plain {mean[k + '_plain']:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{mean[k] / bound_ms:.1f}x) per call on F={FRAMES} {W}x{H} "
          f"frames of the directional sweep  [{card}]")
    rows.append({"name": k, "route": "cuda", "source": DIRECTIONAL_SOURCE[0],
                 "replaces": DIRECTIONAL_SOURCE[1],
                 "launches": mode_launches[k], "max_abs_err": errs[k],
                 "ms": mean[k], "plain_ms": mean[k + "_plain"],
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None})
    print(f"fused kernel {mean['fused']:.4f} ms vs trace + shadow kernels "
          f"{mean['trace'] + mean['shadow']:.4f} ms (G-buffer mode), "
          f"{mean['trace'] + mean['shadow_shade']:.4f} ms (winner inputs) "
          f"per F={FRAMES} call  "
          f"[{card}]")

    # -- 14. BASELINE config 5: supersampled at s = 2 and 4; a 21,632-bin
    #        grid ---------------------------------------------------------
    rows += config5_phase(card)
    rows += wide_grid_phase(card)
    rows += binning_phase(card)

    # -- 15. the run entry points: bench, bench_scale --nonramp, make_demo --
    renderer.fuse_trace_shadow = False
    rows += bench_scale_phase(card)
    bench_phase(card, scene)
    make_demo_phase(card, scene)

    # -- 16. the brute renderer, the session, the viewer, render_long -------
    rows += brute_phase(card, scene, ds, renderer)
    rows += session_phase(card, scene, cfg)
    rows += viewer_phase(card, scene, cfg)
    rows += config2_phase(card)

    # -- 17. the inverse fitter and the sharded paths ------------------------
    renderer.fuse_trace_shadow = False
    rows += inverse_phase(card, ds, renderer, anim, sweeps["center"])
    rows += parallel_phase(card, scene, ds, renderer, anim, sweeps["center"])
    print(json.dumps({"kernels": rows}))

    # -- 18. result ----------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
