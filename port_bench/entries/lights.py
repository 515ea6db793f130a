"""Batched renders under several point lights a frame whose diffuse adds:
``AnimationRenderer.render_states`` with (F, L, 3) lights on a
``StaticBins`` cache of the scene (the player the one dynamic entity).
On the program's main path that is the bins merge, ``trace.cu``, then
``shadow.cu``'s multi-light mode in one launch
(``batched.shade_lights_stage``); a program without that stage renders
the same call on its G-buffer route, and then the stage split is not
read.

The closed loop, the per-frame checksums, the sample and the renderer
are the batch entry's (``entries/batch.py``, loaded by path); only the
lights differ: light l of every frame orbits the mix's centre l (x
radius ``radius``, z radius ``radius // 2``, period ``period`` frames, as
``traffic.batch_states`` draws one orbit), each from its own phase drawn
from the seed.  ``mrays_per_s`` keeps the harness's two rays a traced
pixel, though a frame traces 1 + L.
"""

from __future__ import annotations

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models import batched

from port_bench import harness, spec, traffic
from port_bench.reference import lights as reference_lights

batch = spec.load_module(spec.ROOT / "entries" / "batch.py")

# The generator's stream of the lights' phases (batch_states takes 0 and
# 1, the request stream 2, the sample 3).
PHASE_STREAM = 4


def orbit_lights(mix: dict, config: dict, seed: int) -> np.ndarray:
    """(prestaged_batches, F, L, 3) int32 in traced-world units, L the
    configuration's ``lights``: light l of frame n at angle ``phase_l + 2
    pi n / period`` around centre l, truncated to int."""
    s = config["supersample"]
    n, F = mix["prestaged_batches"], mix["frames_per_batch"]
    light = mix["light"]
    centers = np.asarray(light["centers"], np.int64)
    if centers.shape != (config["lights"], 3):
        raise ValueError(f"{config['lights']} lights a frame need as many "
                         f"orbit centres, not {centers.shape}")
    phase = traffic.rng(seed, PHASE_STREAM).uniform(0.0, 2.0 * np.pi,
                                                    len(centers))
    frame = np.arange(n * F).reshape(n, F, 1)
    angle = phase + 2.0 * np.pi * frame / light["period"]
    radius = light["radius"]
    lights = np.stack([centers[:, 0] + radius * np.cos(angle),
                       np.broadcast_to(centers[:, 1], angle.shape),
                       centers[:, 2] + (radius // 2) * np.sin(angle)],
                      axis=-1)
    return (lights * s).astype(np.int32)


class Entry(batch.Entry):
    def __init__(self, cell, arrays, seed: int, device):
        super().__init__(cell, arrays, seed, device)
        self.lights = torch.as_tensor(
            orbit_lights(cell.traffic, cell.config, seed), device=device)
        self.shapes["lights"] = self.lights.shape[2]

    def stages(self, n: int) -> dict:
        """The main path's stages on batches 0..n-1, each between CUDA
        events, in the order ``render_states_batched`` calls them: bins,
        trace and the multi-light stage, which on the card has to be one
        launch of its kernel; the frames must equal ``render_states``' or
        the split is not read.  A program without the multi-light stage
        has no split."""
        stage = getattr(batched, "shade_lights_stage", None)
        if stage is None:
            return {"split_ok": False}
        r, ds, cache = self.anim.renderer, self.dscene, self.anim.static_bins
        kernel = getattr(batched, "shadow_cuda", None)
        names = ("bins", "trace", "lights")
        clock = harness.StageClock(ds.device, names)
        for b in range(n):
            players, lights = self.batch(b)
            clock.mark()
            bins_ent, counts = batched.bin_stage(r, cache, ds, players)
            clock.mark()
            winners = batched.winner_stage(r, ds, bins_ent, counts, players)
            clock.mark()
            launched = getattr(kernel, "light_launches", 0)
            frames = stage(r, ds, bins_ent, counts, players, winners, lights)
            clock.mark()
            clock.close()
            one = getattr(kernel, "light_launches", 0) - launched \
                == int(frames.is_cuda)
            if not one or not torch.equal(frames, self.submit(b)[0]):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n * self.F,
                **clock.ms}


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """The reference's frames of the samples' (player, lights) states, in
    chunks of at most ``harness.REFERENCE_PIXELS`` pixel-lights."""
    if not samples:
        return []
    scene = harness.reference_scene(arrays, cell.config, device)
    v = harness.view(cell.config)
    players = torch.as_tensor(np.stack([x[0] for x in samples]),
                              dtype=torch.int32, device=device)
    lights = torch.as_tensor(np.stack([x[1] for x in samples]),
                             dtype=torch.int32, device=device)
    step = max(1, harness.REFERENCE_PIXELS
               // (v.width * v.height * lights.shape[1]))
    frames = torch.cat([reference_lights.render_frames(
        scene, players[i:i + step], lights[i:i + step], v, fdt)
        for i in range(0, players.shape[0], step)])
    return list(frames.cpu().numpy())
