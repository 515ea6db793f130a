"""Where the winner-input mode of ``csrc/shadow.cu`` spends its cycles.

    python -m pixel_art_raytracer_tpu_torch.shade_phases

Builds the kernel library with ``-DPAR_SHADE_PHASES`` (a build directory
of its own, named by the flags), which turns on the phase marks of the
point march as ``shadow_shade_kernel`` runs it (``csrc/common.cuh``
``march_band``'s ``ShadePhaseClock``): thread 0 of every block reads
``clock64()`` at each mark and adds each phase's cycles to a device
array, which the C entry ``par_shade_phases`` copies out and clears.  Runs ``shadow_cuda.shade_point`` once on graybox (the center
orbit, F = 64) and on BASELINE config 5 at s = 4 (F = 2) and s = 2 (F =
8), and prints a JSON line for each: the blocks, the mean cycles a block,
and each phase's share of them.  The phases, in order: decode (each
pixel's surface and ray, each warp's start bins), the merge into the
band's table, the keys' set-up, and per chunk the listing (the DDA
rounds), the staging of boxes and the march (with the keys'
bookkeeping); last, the direct march and the store.  Each mark follows a
block barrier, so a phase's cycles are thread 0's from barrier to
barrier: the block's critical path, with the other blocks on its SM
running meanwhile.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json

import torch

from . import DEFAULT_CONFIG, default_light, graybox_world, require_cuda
from .models import batched
from .models.animation import AnimationRenderer
from .models.deferred import DeferredRenderer, DeviceScene
from .ops import shadow_cuda, trace_cuda
from .ops.static_bins import StaticBins
from .runtime import kernels
from .time_kernels import config5_winners

# The kernel's phases, in the order of its marks (kShadePhases of them).
PHASES = ("decode", "merge", "key setup", "listing", "staging", "march",
          "direct + store")
FLAG = "-DPAR_SHADE_PHASES"


def load() -> ctypes.CDLL:
    """Build the library with the phase marks on as this process's kernel
    library; call before anything else builds it."""
    kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS, FLAG)
    lib = kernels.library()
    lib.par_shade_phases.argtypes = [ctypes.c_void_p]
    lib.par_shade_phases.restype = ctypes.c_int
    return lib


def phases(lib: ctypes.CDLL, label: str, args: tuple) -> dict:
    """One ``shade_point`` call on ``args``: its blocks, mean cycles a
    block and each phase's share."""
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    kernels.check(lib.par_shade_phases(ctypes.addressof(out)),
                  "par_shade_phases")
    shadow_cuda.shade_point(*args)
    torch.cuda.synchronize()
    kernels.check(lib.par_shade_phases(ctypes.addressof(out)),
                  "par_shade_phases")
    cycles = list(out)[:len(PHASES)]
    blocks = out[len(PHASES)]
    return {"scene": label, "blocks": blocks,
            "cycles_per_block": sum(cycles) / blocks,
            "share": {p: c / sum(cycles) for p, c in zip(PHASES, cycles)}}


def graybox_winners() -> tuple:
    """``shade_point``'s arguments on graybox's center orbit, F = 64."""
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
    win = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_depth, be, cnt, players, cfg)
    return (win, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, cfg)


def main() -> None:
    require_cuda()
    lib = load()
    for label, make in (("graybox, F = 64", graybox_winners),
                        ("config 5, s = 4, F = 2", lambda: config5_winners()),
                        ("config 5, s = 2, F = 8",
                         lambda: config5_winners(2, 8))):
        print(json.dumps(phases(lib, label, make())))


if __name__ == "__main__":
    main()
