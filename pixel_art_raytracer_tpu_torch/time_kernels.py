"""Time the trace and fused kernels on graybox, for comparing two trees.

    PYTHONPATH=<tree> python3 <this file> <label>

Builds the kernels of the package found first on the path, renders nothing
but the bin tables of the graybox world's center light orbit (F = 64), and
prints one JSON line: ``label``, five means of 50 calls of
``trace_cuda.trace_winners`` and three means of 20 calls of
``fused_cuda.trace_shadow``, in ms, CUDA events after a warm-up.  Two trees
are compared in one call on one card, in turns (parent, change, change,
parent), since cards and their hosts differ between calls.  Needs a CUDA
card.
"""

import json
import sys

import torch

from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, default_light,
                                           graybox_world, require_cuda)
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import fused_cuda, trace_cuda
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


def main(label: str) -> dict:
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
    return {"tree": label,
            "trace_ms": [ms(lambda: trace_cuda.trace_winners(*args), 50)
                         for _ in range(5)],
            "fused_ms": [ms(lambda: fused_cuda.trace_shadow(
                *args[:-1], lights, cfg), 20) for _ in range(3)]}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else "tree")))
