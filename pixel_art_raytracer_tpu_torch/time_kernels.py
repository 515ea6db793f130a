"""Time the three kernels on graybox, for comparing two trees.

    PYTHONPATH=<tree> python3 <this file> <label> [--shade-sweep]

Builds the kernels of the package found first on the path and prints one
JSON line: ``label``, then in ms (CUDA events after a warm-up) five means
of 50 calls of ``trace_cuda.trace_winners`` and three means of 20 calls of
``fused_cuda.trace_shadow`` on the bin tables of the graybox world's
center light orbit (F = 64), three means of 20 calls of
``shadow_cuda.trace_light`` (point mode) on that orbit's G-buffer and
lights, three means of 20 calls of ``shadow_cuda.shade_point`` (the
winner-input point mode, frames out, and then its lit mask) on that
orbit's winners and lights where the tree has it, three means of 5
batches of that orbit through
``AnimationRenderer.render_states`` (the main path, ms per batch of 64
frames), three means of 20 calls of
``shadow_cuda.trace_light_directional`` on chip_smoke.py's directional
sweep (64 directions (cos t, 1, 0.5 sin t), the player at home, the step
cap ``shadow_dir.grid_max_steps``), and three means of 5 batches of that
sweep through ``AnimationRenderer.render_states(..., directional=True)``
(the directional path, ms per batch of 64 frames).  Where the tree has
``shade_directional`` it times three means of 20 of its calls (the
winner-input directional mode, dithered frames out) on that sweep's
winners.  Where the tree has
``shade_point`` it also times three means of 5 of its calls on BASELINE
config 5 at s = 4 (``bench_scale``'s scene and light orbit, F = 2, 4096**2
pixels in bins of 160) and at s = 2 (F = 8, and three means of 3 calls
at F = 64: 2048**2 pixels in bins of 80, the benchmark's config 5
batches).  With ``--shade-sweep`` (trees whose winner-input
mode streams its lists, ``shadow_cuda.shade_chunk``) it times that mode on
both scenes at several chunk lengths, each with its shared memory and
blocks per SM.  Apart from ``shade_point`` and ``shade_directional``,
which it skips where they are missing, it uses only calls whose
signatures are the same in earlier trees, so one copy of it times both
trees.  Two trees are compared in one call on one card, in turns
(parent, change, change, parent), since cards and their hosts differ
between calls.  Needs a CUDA card.
"""

import json
import sys

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, default_light,
                                           graybox_world, require_cuda)
from pixel_art_raytracer_tpu_torch import bench_scale
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer, scale_scene)
from pixel_art_raytracer_tpu_torch.ops import (fused_cuda, shadow_cuda,
                                               shadow_dir, trace, trace_cuda)
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels


def ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def config5_winners(factor: int = 4, frames: int = 2) -> tuple:
    """``shade_point``'s arguments on BASELINE config 5 at s = ``factor``:
    ``frames`` states of ``bench_scale``'s light orbit, the trace kernel's
    winners."""
    ss = SupersampledRenderer(bench_scale.CONFIG, factor)
    cfg, r = ss.config, ss.renderer
    scene = bench_scale.config5_scene()
    ds = ss.prepare(scene)
    scaled = scale_scene(scene, factor)
    cache = StaticBins(scaled.pos, scaled.ext, 1, cfg, r.spans)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    players, lights = anim.light_sweep_states(
        frames, scaled.pos[0],
        center=tuple(c * factor for c in bench_scale.LIGHT),
        radius=bench_scale.ORBIT_RADIUS * factor)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    win = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_depth, be, cnt, players, cfg)
    return (win, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, cfg)


# Chunks of the winner-input mode that ``--shade-sweep`` times; None is
# ``shadow_cuda.shade_chunk``'s.
SHADE_CHUNKS = (None, 32, 28, 24, 16, 64)


def shade_sweep(scenes: dict) -> list[dict]:
    """The winner-input mode's ms a call (three means of 10 calls) on each
    of ``scenes`` (name -> ``shade_point`` arguments) at each of
    SHADE_CHUNKS, with its shared memory and blocks per SM; the module's
    chunk is restored after."""
    saved = shadow_cuda.shade_chunk
    out = []
    try:
        for chunk in SHADE_CHUNKS:
            shadow_cuda.shade_chunk = (saved if chunk is None
                                       else lambda config, c=chunk: c)
            for name, args in scenes.items():
                smem, blocks, regs, local = shadow_cuda.shade_occupancy(
                    args[-1])
                out.append({"scene": name,
                            "chunk": shadow_cuda.shade_chunk(args[-1]),
                            "smem": smem,
                            "blocks_per_sm": blocks, "ms": [
                                ms(lambda: shadow_cuda.shade_point(*args),
                                   10) for _ in range(3)]})
    finally:
        shadow_cuda.shade_chunk = saved
    return out


def main(label: str, sweep: bool = False) -> dict:
    require_cuda()
    kernels.library()
    cfg = DEFAULT_CONFIG
    scene = graybox_world(cfg)
    r = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg)
    light = default_light(cfg)
    players, lights = anim.light_sweep_states(
        64, scene.pos[0], center=(light.x, light.y, light.z), radius=40)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, players,
            cfg)
    win = trace_cuda.trace_winners(*args)
    gbuf = trace.materialize_gbuffer(
        win, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color, ds.atlas_depth,
        ds.atlas_normal, ds.palette, players, cfg)
    _, inv, origin, rb, lb = batched.geometry_stage(r, gbuf, lights)
    sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
             inv, players, cfg)

    # The directional sweep on the same G-buffer: a light sweep leaves the
    # player at home in every frame.
    t = 2.0 * np.pi * np.arange(64) / 64
    dirs = np.stack([np.cos(t), np.ones(64), 0.5 * np.sin(t)], axis=1)
    dirs = torch.as_tensor(dirs.astype(np.float32), device=players.device)
    tl, dinv, K = shadow_dir.direction_constants(dirs, cfg)
    dargs = (ds.pos, ds.ext, be, cnt, gbuf.y, gbuf.z, gbuf.entity_index,
             dinv, K, players, cfg, shadow_dir.grid_max_steps(cfg))
    out = {"tree": label,
           "trace_ms": [ms(lambda: trace_cuda.trace_winners(*args), 50)
                        for _ in range(5)],
           "fused_ms": [ms(lambda: fused_cuda.trace_shadow(
               *args[:-1], lights, cfg), 20) for _ in range(3)],
           "shadow_ms": [ms(lambda: shadow_cuda.trace_light(*sargs), 20)
                         for _ in range(3)]}
    if hasattr(shadow_cuda, "shade_point"):
        wargs = (win, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
                 ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt,
                 players, lights, cfg)
        out["shade_ms"] = [ms(lambda: shadow_cuda.shade_point(*wargs), 20)
                           for _ in range(3)]
        out["shade_lit_ms"] = [ms(lambda: shadow_cuda.shade_point(
            *wargs, frames=False), 20) for _ in range(3)]
        c5args = config5_winners()
        out["shade_config5_s4_ms"] = [
            ms(lambda: shadow_cuda.shade_point(*c5args), 5) for _ in range(3)]
        if sweep:
            out["shade_sweep"] = shade_sweep({"graybox": wargs,
                                              "config5_s4": c5args})
        del c5args
        for frames, reps in ((8, 5), (64, 3)):
            c5args = config5_winners(2, frames)
            out[f"shade_config5_s2_f{frames}_ms"] = [
                ms(lambda: shadow_cuda.shade_point(*c5args), reps)
                for _ in range(3)]
            del c5args
    if hasattr(shadow_cuda, "shade_directional"):
        dsargs = (win, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
                  ds.atlas_depth, ds.atlas_normal, ds.palette,
                  ds.palette_luma, be, cnt, players, tl, dinv, K, cfg,
                  "dithered")
        out["dir_shade_ms"] = [ms(lambda: shadow_cuda.shade_directional(
            *dsargs), 20) for _ in range(3)]
    return {**out,
            "point_path_ms": [ms(lambda: anim.render_states(
                ds, players, lights), 5) for _ in range(3)],
            "directional_ms": [ms(lambda: shadow_cuda.trace_light_directional(
                *dargs), 20) for _ in range(3)],
            "directional_path_ms": [ms(lambda: anim.render_states(
                ds, players, dirs, directional=True), 5)
                for _ in range(3)]}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--shade-sweep"]
    print(json.dumps(main(args[0] if args else "tree",
                          "--shade-sweep" in sys.argv[1:])))
