#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Builds both CUDA kernels from ``pixel_art_raytracer_tpu_torch/csrc`` and the
C++ oracle, renders the graybox world (480x320, 162,308 boxes) through
``AnimationRenderer.render_states`` for the three light orbits of
``bench.py`` (F = 64 frames each), and fails (exit code != 0) unless:

  * each kernel equals its plain PyTorch version bit for bit on the card,
    on all 64 frames of every orbit (the main path's shapes);
  * both kernels' launch counters rose during the main-path run;
  * the rendered frames equal ``runtime.native.cpp_render_frame`` pixel for
    pixel (frame 0 of every orbit and one mid-sweep frame of ``edge_z``).

It prints the card, the build time, ms/frame, Mrays/s and the per-stage
split, the kernels' times beside their plain versions, a JSON line on the
kernels and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with an error before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 64
TIMED_REPS = 5
KERNEL_REPS = 20
PLAIN_REPS = 1


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def main() -> int:
    from pixel_art_raytracer_tpu.config import DEFAULT_CONFIG as cfg
    from pixel_art_raytracer_tpu.runtime import native
    from pixel_art_raytracer_tpu.scene import Light, default_light, \
        graybox_world
    from pixel_art_raytracer_tpu_torch.device import require_cuda
    from pixel_art_raytracer_tpu_torch.models import batched
    from pixel_art_raytracer_tpu_torch.models.animation import \
        AnimationRenderer
    from pixel_art_raytracer_tpu_torch.models.deferred import (
        DeferredRenderer, DeviceScene)
    from pixel_art_raytracer_tpu_torch.ops import (shadow, shadow_cuda,
                                                   trace, trace_cuda)
    from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
    from pixel_art_raytracer_tpu_torch.runtime import kernels

    # -- 1. the card ---------------------------------------------------------
    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    # -- 2. build the kernels and the C++ oracle -----------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({kernels.build_dir().name})")
    t0 = time.perf_counter()
    if native.load_library() is None:
        raise RuntimeError("the C++ oracle (native/par_native.cpp) did not "
                           "build")
    print(f"oracle build: {time.perf_counter() - t0:.2f} s")

    # -- 3. scene, caches and the three bench orbits -------------------------
    t0 = time.perf_counter()
    scene = graybox_world(cfg)
    renderer = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans,
                       device=dev)
    anim = AnimationRenderer(renderer, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg, device=dev)
    light = default_light(cfg)
    orbits = {
        "center": (light.x, light.y, light.z),
        "edge_x": (20, light.y, light.z),
        "edge_z": (light.x, light.y, 280),
    }
    sweeps = {name: anim.light_sweep_states(FRAMES, scene.pos[0], center=c,
                                            radius=40, device=dev)
              for name, c in orbits.items()}
    torch.cuda.synchronize()
    print(f"setup: {scene.n_entities} entities, spans {renderer.spans}, "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 4. each kernel against its plain version, at the main path's shapes --
    errs = {"trace": 0, "shadow": 0}
    times = {"trace": [], "trace_plain": [], "shadow": [],
             "shadow_plain": []}
    for name, (players, lights) in sweeps.items():
        be, cnt = batched.bin_stage(renderer, cache, ds, players)
        args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt,
                players, cfg)
        best_k, win_k = trace_cuda.trace_winners(*args, with_best=True)
        best_p, win_p = trace.trace_winner(*args)
        if not (torch.equal(win_k, win_p) and torch.equal(best_k, best_p)):
            raise RuntimeError(
                f"{name}: trace kernel != trace_winner at "
                f"{int((win_k != win_p).sum())} pixels")
        errs["trace"] = max(errs["trace"], max_abs_err(win_k, win_p))
        times["trace"].append(cuda_ms(lambda: trace_cuda.trace_winners(*args),
                                      KERNEL_REPS))
        times["trace_plain"].append(cuda_ms(lambda: trace.trace_winner(*args),
                                            PLAIN_REPS, warm_up=False))

        gbuf = trace.materialize_gbuffer(
            win_k, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, players, cfg)
        _, inv, origin, rb, lb = batched.geometry_stage(renderer, gbuf,
                                                        lights)
        sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
                 inv, players, cfg)
        lit_k = shadow_cuda.trace_light(*sargs)
        lit_p = shadow.trace_light_dynamic(*sargs)
        if not torch.equal(lit_k, lit_p):
            raise RuntimeError(
                f"{name}: shadow kernel != trace_light_dynamic at "
                f"{int((lit_k != lit_p).sum())} pixels")
        errs["shadow"] = max(errs["shadow"], max_abs_err(lit_k, lit_p))
        times["shadow"].append(cuda_ms(lambda: shadow_cuda.trace_light(*sargs),
                                       KERNEL_REPS))
        times["shadow_plain"].append(
            cuda_ms(lambda: shadow.trace_light_dynamic(*sargs), PLAIN_REPS,
                    warm_up=False))
        print(f"{name}: F={FRAMES} kernels == plain versions (trace winners "
              f"and best depth, shadow lit mask), bit-exact")

    # -- 5. the main path ----------------------------------------------------
    trace_cuda.launches = 0
    shadow_cuda.launches = 0
    frames = {name: anim.render_states(ds, players, lights)
              for name, (players, lights) in sweeps.items()}
    torch.cuda.synchronize()
    launches = {"trace": trace_cuda.launches, "shadow": shadow_cuda.launches}
    print(f"main-path launches: {launches}")
    for k, n in launches.items():
        if n == 0:
            raise RuntimeError(f"the main path never launched the {k} "
                               f"kernel")

    H, W = cfg.view_height, cfg.view_width
    rays = 2 * W * H * FRAMES
    for name, (players, lights) in sweeps.items():
        ms = cuda_ms(lambda: anim.render_states(ds, players, lights),
                     TIMED_REPS)
        print(f"{name}: F={FRAMES} {ms / FRAMES:.4f} ms/frame, "
              f"{rays / (ms * 1e3):.2f} Mrays/s  [{card}]")

    players, lights = sweeps["center"]
    stage_ms = dict.fromkeys(
        ("bins", "trace+gbuffer", "geometry", "shadow", "shade"), 0.0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    for rep in range(TIMED_REPS + 1):
        torch.cuda.synchronize()
        events[0].record()
        be, cnt = batched.bin_stage(renderer, cache, ds, players)
        events[1].record()
        gbuf = batched.trace_stage(renderer, ds, be, cnt, players)
        events[2].record()
        dot, inv, origin, rb, lb = batched.geometry_stage(renderer, gbuf,
                                                          lights)
        events[3].record()
        lit = batched.shadow_stage(renderer, ds, be, cnt, players, gbuf, inv,
                                   origin, rb, lb)
        events[4].record()
        batched.shade_stage(renderer, gbuf, dot, lit)
        events[5].record()
        torch.cuda.synchronize()
        if rep:  # rep 0 is the warm-up
            for i, key in enumerate(stage_ms):
                stage_ms[key] += (events[i].elapsed_time(events[i + 1])
                                  / TIMED_REPS / FRAMES)
    split = ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
    print(f"center stage split, ms/frame at F={FRAMES}: {split}  [{card}]")

    # -- 6. parity against the C++ oracle ------------------------------------
    checks = [(name, 0) for name in sweeps] + [("edge_z", FRAMES // 2)]
    for name, f in checks:
        players, lights = sweeps[name]
        frame = frames[name][f].cpu().numpy()
        pos = scene.pos.copy()
        pos[0] = players[f].cpu().numpy()
        golden, _ = native.cpp_render_frame(
            scene.replace_pos(pos), Light(*map(int, lights[f].tolist())), cfg)
        bad = int((frame != golden).any(axis=-1).sum())
        if bad:
            print(f"PARITY FAIL {name} frame {f}: {bad} pixels differ from "
                  f"cpp_render_frame")
            return 1
        print(f"{name} frame {f}: pixel-exact against cpp_render_frame")

    # -- 7. kernel times beside their plain versions -------------------------
    mean = {k: float(np.mean(v)) for k, v in times.items()}
    for k in ("trace", "shadow"):
        print(f"{k} kernel {mean[k]:.4f} ms, plain {mean[k + '_plain']:.4f} "
              f"ms per call on F={FRAMES} 480x320 frames (mean of 3 orbits)"
              f"  [{card}]")
    sources = {
        "trace": ("pixel_art_raytracer_tpu_torch/csrc/trace.cu",
                  "pixel_art_raytracer_tpu/ops/trace_pallas.py:467"),
        "shadow": ("pixel_art_raytracer_tpu_torch/csrc/shadow.cu",
                   "pixel_art_raytracer_tpu/ops/shadow_pallas.py:626"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k], "ms": mean[k],
         "plain_ms": mean[k + "_plain"]}
        for k, (src, rep) in sources.items()]}))

    # -- 8. result -----------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
