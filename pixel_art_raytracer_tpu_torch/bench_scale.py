"""BASELINE config 5 on the card: supersampled rendering of a big scene.

    python -m pixel_art_raytracer_tpu_torch.bench_scale [factor=2] [iters=3]
        [frames=8] [--nonramp]

The counterpart of ``tools/bench_scale.py``, which benches the JAX package.
It renders 10,000 boxes on a 1024x1024 base view supersampled s =
``factor`` times (the render runs at (1024 s)**2 and is box-filtered back
to 1024**2) through ``SupersampledRenderer``:

* the single frame ``render`` at light (512, 200, 80): best of ``iters``
  ms/frame;
* a batched light sweep of ``frames`` states around (512 s, 200 s, 80 s)
  at radius 40 s through ``AnimationRenderer.render_states`` on a
  ``StaticBins`` cache, frames and their checksums delivered: best and
  median of ``iters`` ms/frame and Mrays/s at the traced size (2 (1024
  s)**2 rays a frame), on the two-kernel path and, under ``fused``, with
  ``fuse_trace_shadow``.

CUDA events time both.  ``--nonramp`` gives every other box the second
sprite of a two-sprite atlas whose top face is 3 deeper in its right half:
a depth map that varies along a row, which the walk of ``trace.cu`` and
``fused.cu`` reads texel by texel.

Parity: frame 0 of each path's last timed batch equals
``cpp_render_frame`` of the scaled scene, and ``render`` of that state's
base light equals the oracle frame box-filtered to 1024**2.  Otherwise
the counts of differing pixels go to stderr, no result is printed and the
exit code is 1.  The last line of output is one JSON object.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import NamedTuple

import numpy as np
import torch

from .assets import SpriteAtlas, make_tile_floor
from .bench import PATHS, delivered, launch_tally, on_path, timed_ms
from .config import RenderConfig
from .device import card, require_cuda, resolve
from .models.animation import AnimationRenderer
from .models.deferred import DeferredRenderer, DeviceScene
from .models.supersample import SupersampledRenderer, box_filter, scale_scene
from .ops.static_bins import StaticBins
from .runtime import kernels, native
from .scene import Light, Scene, SceneBuilder

CONFIG = RenderConfig(view_width=1024, view_height=1024, view_length=320)
BOXES = 10_000
LIGHT = (512, 200, 80)
ORBIT_RADIUS = 40
FACTOR = 2
ITERS = 3
FRAMES = 8


class ScaleRun(NamedTuple):
    """What :func:`run` measured (``summary``, the JSON line) and what it
    rendered with: the scaled renderer and scene, the cache and the
    states.  ``differing`` counts the pixels that differ from the oracle:
    each path's frame 0, and ``render`` (``"render"``)."""

    summary: dict
    renderer: DeferredRenderer
    dscene: DeviceScene
    cache: StaticBins
    players: torch.Tensor
    lights: torch.Tensor
    differing: dict[str, int]


def nonramp_atlas() -> SpriteAtlas:
    """The tile floor and a copy whose top face is 3 deeper in its right
    half (two column bands)."""
    tile = make_tile_floor()
    h, w = tile.depth.shape[-2:]
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    depth1 = (np.maximum(0, 19 - r) + np.where(c >= w // 2, 3, 0)).astype(
        np.int32)
    return SpriteAtlas(color=np.stack([tile.color[0], tile.color[0]]),
                       depth=np.stack([tile.depth[0], depth1]),
                       normal=np.stack([tile.normal[0], tile.normal[0]]))


def config5_scene(nonramp: bool = False,
                  config: RenderConfig = CONFIG) -> Scene:
    """The player at (500, 36, 80), then 9,999 boxes of 20**3 at x = 37 i
    mod 1040, z = 53 i mod 300, y = 20 where i mod 7 = 0, else 0; with
    ``nonramp`` box i takes sprite i mod 2 of :func:`nonramp_atlas`, else
    all take the tile floor.  ``config`` is the view the boxes are binned
    for (config 5's 1024**2 by default)."""
    b = SceneBuilder(config=config,
                     atlas=nonramp_atlas() if nonramp else None)
    b.insert((500, 36, 80), (20, 20, 20))
    for i in range(BOXES - 1):
        b.insert(((i * 37) % 1040, 20 if i % 7 == 0 else 0, (i * 53) % 300),
                 (20, 20, 20), sprite_id=i % 2 if nonramp else 0)
    return b.build()


def batch_figures(ms: list[float], frames: int, rays: int) -> dict:
    """Best and median ms/frame and Mrays/s of batch times ``ms``."""
    best, median = min(ms), statistics.median(ms)
    return {"batch_best_ms_per_frame": best / frames,
            "batch_median_ms_per_frame": median / frames,
            "batch_best_mrays": rays * frames / best / 1e3,
            "batch_median_mrays": rays * frames / median / 1e3}


def run(device=None, scene: Scene | None = None, factor: int = FACTOR,
        iters: int = ITERS, frames: int = FRAMES,
        config: RenderConfig = CONFIG, light=LIGHT) -> ScaleRun:
    """Measure ``scene`` (default: config 5 with the tile floor) on
    ``config`` supersampled ``factor`` times, on ``device`` (default: the
    card; the CPU only when named, with host-clock times).  Each timing
    follows one untimed warm-up call.  The summary's ``launches`` counts a
    single frame as a batch of the two-kernel path."""
    dev = resolve(device)
    where = card() if dev.type == "cuda" else str(dev)
    scene = config5_scene() if scene is None else scene
    native.library()
    if dev.type == "cuda":
        kernels.library()
    ss = SupersampledRenderer(config, factor)
    cfg, r = ss.config, ss.renderer
    ds = ss.prepare(scene, device=dev)
    scaled = scale_scene(scene, factor)
    cache = StaticBins(scaled.pos, scaled.ext, 1, cfg, r.spans, device=dev)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    players, lights = anim.light_sweep_states(
        frames, scaled.pos[0], center=tuple(c * factor for c in light),
        radius=ORBIT_RADIUS * factor, device=dev)
    side = cfg.view_width
    rays = 2 * cfg.view_width * cfg.view_height

    # A single frame is a batch of one on the two-kernel path.
    tally = launch_tally()
    base = torch.tensor(light, dtype=torch.int32, device=dev)
    single = [on_path(r, "two_kernel", tally, 1, lambda: timed_ms(
        dev, lambda: ss.render(ds, base)))[1] for _ in range(iters + 1)][1:]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    batch_ms = {p: [] for p in PATHS}
    last = {}
    for rep in range(iters + 1):  # the first pass warms up
        for path in PATHS:
            out, ms = on_path(r, path, tally, 1, lambda: timed_ms(
                dev, lambda: delivered(anim, ds, players, lights)))
            if rep:
                batch_ms[path].append(ms)
                last[path] = out
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)

    golden, _ = native.cpp_render_frame(
        scaled, Light(*map(int, lights[0].tolist())), cfg)
    differing = {p: int((last[p][0][0].cpu().numpy() != golden)
                        .any(axis=-1).sum()) for p in PATHS}
    light0 = lights[0].cpu()
    if bool((light0 % factor).any()):
        raise RuntimeError(f"the sweep's first light {light0.tolist()} is "
                           f"not a scaled base light")
    filtered = box_filter(torch.from_numpy(golden), factor)
    small = on_path(r, "two_kernel", tally, 1,
                    lambda: ss.render(ds, (light0 // factor).to(dev)))
    differing["render"] = int((small.cpu() != filtered).any(dim=-1).sum())

    best = min(single)
    summary = {
        "metric": f"config 5 batched light sweep ms/frame at {side}x{side} "
                  f"(s={factor}, {scene.n_entities} boxes, primary+shadow, "
                  f"F={frames}, best of {iters})",
        "value": min(batch_ms["two_kernel"]) / frames,
        "unit": "ms/frame",
        "factor": factor,
        "side": side,
        "boxes": scene.n_entities,
        "depth_varies_along_rows": not scene.atlas.depth_is_row_only,
        "frames": frames,
        "rays_per_frame": rays,
        "single_frame_ms": best,
        "single_frame_mrays": rays / best / 1e3,
        **batch_figures(batch_ms["two_kernel"], frames, rays),
        "parity": differing["two_kernel"] == differing["render"] == 0,
        "fused": {**batch_figures(batch_ms["fused"], frames, rays),
                  "parity": differing["fused"] == 0},
        "peak_gib": peak,
        "launches": tally,
        "device": where,
    }
    return ScaleRun(summary, r, ds, cache, players, lights, differing)


def main(argv=None) -> int:
    require_cuda()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("factor", nargs="?", type=int, default=FACTOR)
    parser.add_argument("iters", nargs="?", type=int, default=ITERS)
    parser.add_argument("frames", nargs="?", type=int, default=FRAMES)
    parser.add_argument("--nonramp", action="store_true",
                        help="half the boxes get a depth map that varies "
                             "along a row")
    args = parser.parse_args(argv)
    print(card())
    scene = config5_scene(args.nonramp)
    side = CONFIG.view_width * args.factor
    print(f"scene: {scene.n_entities} entities; render at {side}x{side} "
          f"(s={args.factor})")
    result = run("cuda", scene, args.factor, args.iters, args.frames)
    if any(result.differing.values()):
        print(f"PARITY FAILURE: pixels differing from the C++ oracle "
              f"{result.differing}", file=sys.stderr)
        return 1
    print(json.dumps(result.summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
