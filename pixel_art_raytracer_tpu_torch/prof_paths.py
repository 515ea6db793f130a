"""Launches, device time and idle share of the port's two render paths.

    python -m pixel_art_raytracer_tpu_torch.prof_paths [--frames 64] [--batches 3]

Renders the graybox world through ``AnimationRenderer.render_states`` on
the center light orbit of ``bench.py`` (radius 40 around the default
light), once on the two-kernel path (``trace.cu``, then the winner-input
mode of ``shadow.cu``) and once with ``fuse_trace_shadow``.
For each path it runs one warm-up batch, then records ``--batches`` batches
issued back to back under ``torch.profiler`` and reads the device
activities (kernels, copies, fills) from the exported trace.  It prints per
batch the device launches and the busy time (the union of the activities'
intervals), the idle share of the span from the first activity's start to
the last one's end (1 - busy / span), and the kernels with the most device
time.  Needs a CUDA card; the traces are left in ``build/prof/``.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from . import DEFAULT_CONFIG, default_light, graybox_world, require_cuda
from .models.animation import AnimationRenderer
from .models.deferred import DeferredRenderer, DeviceScene
from .ops.static_bins import StaticBins

TRACE_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "prof"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activities(trace: pathlib.Path) -> list[tuple[float, float, str]]:
    """``(start_us, end_us, name)`` of every device activity in a chrome
    trace exported by ``torch.profiler``."""
    events = json.loads(trace.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)


def busy_us(acts) -> float:
    """Length of the union of the activities' intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in acts:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--batches", type=int, default=3)
    args = parser.parse_args()
    require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]

    cfg = DEFAULT_CONFIG
    scene = graybox_world(cfg)
    renderer = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, renderer.spans)
    anim = AnimationRenderer(renderer, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg)
    light = default_light(cfg)
    players, lights = anim.light_sweep_states(
        args.frames, scene.pos[0], center=(light.x, light.y, light.z),
        radius=40)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)

    for label, fuse in (("two-kernel", False), ("fused", True)):
        renderer.fuse_trace_shadow = fuse
        anim.render_states(ds, players, lights)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.batches):
                anim.render_states(ds, players, lights)
            torch.cuda.synchronize()
        trace = TRACE_DIR / f"{label}.json"
        prof.export_chrome_trace(str(trace))
        acts = device_activities(trace)
        if not acts:
            raise RuntimeError(f"{label}: the trace holds no device activity")
        n = args.batches
        busy = busy_us(acts)
        span = acts[-1][1] - acts[0][0]
        by_name = collections.Counter()
        for s, e, name in acts:
            by_name[name] += e - s
        print(f"{label}: F={args.frames}, {len(acts) / n:.1f} device "
              f"launches per batch, busy {busy / n / 1e3:.4f} ms per batch, "
              f"span {span / n / 1e3:.4f} ms per batch, idle share "
              f"{1 - busy / span:.4f}  [{card}]")
        for name, us in by_name.most_common(5):
            print(f"  {us / n / 1e3:.4f} ms per batch ({us / busy:.1%} of "
                  f"busy): {name[:90]}")


if __name__ == "__main__":
    main()
