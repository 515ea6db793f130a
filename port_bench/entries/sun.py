"""Batched time-of-day renders: ``AnimationRenderer.render_states(...,
directional=True)`` on a ``DeferredRenderer(style="dithered")`` with a
``StaticBins`` cache of the scene (the player the one dynamic entity), so
``render_states_batched`` → ``gbuffer_and_frames``: bins merge,
``trace.cu``, the G-buffer, the directional mode of ``shadow.cu`` and the
ordered dither onto the palette.

The loop is the ``batch`` entry's (``entries/batch.py``): ``in_flight``
batches in flight, each frame's checksum copied into pinned host memory,
a seeded sample of frames kept on the card.  The mix's states are made
here, since the one generator (``traffic.py``) makes point lights only:
frame n of the day loop faces the sun along (cos t, ``y``, ``z_scale``
sin t) as float32, t = phase + 2 pi n / ``period``, the phase uniform
from the seed, and the player stays where the scene puts it.
"""

from __future__ import annotations

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import (shade, shadow_cuda,
                                               shadow_dir, trace)
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels

from port_bench import harness, program, spec, traffic
from port_bench.reference import sun

batch = spec.load_module(spec.ROOT / "entries" / "batch.py")

# The stages of gbuffer_and_frames' directional route, in its order.
STAGES = ("bins", "trace", "gbuffer", "dot", "march", "shade")


def sun_states(mix: dict, seed: int, player0):
    """``(players, directions)``: (prestaged_batches, F, 3) int32 and
    float32, the player at ``player0`` in every frame and the day loop's
    directions toward the sun from a seeded phase."""
    n, F = mix["prestaged_batches"], mix["frames_per_batch"]
    s = mix["sun"]
    phase = traffic.rng(seed, 0).uniform(0.0, 2.0 * np.pi)
    t = phase + 2.0 * np.pi * np.arange(n * F).reshape(n, F) / s["period"]
    directions = np.stack([np.cos(t), np.full_like(t, s["y"]),
                           s["z_scale"] * np.sin(t)], axis=-1)
    players = np.broadcast_to(np.asarray(player0, np.int32), (n, F, 3))
    return players.copy(), directions.astype(np.float32)


class Entry(batch.Entry):
    def __init__(self, cell, arrays, seed: int, device):
        if device.type == "cuda":
            kernels.library()
        cfg, mix = cell.config, cell.traffic
        if (cfg["supersample"], cfg["bayer"]) != (1, 4):
            raise ValueError("the directional dithered path renders at "
                             "supersample 1 with the 4x4 Bayer matrix")
        rcfg = program.render_config(cfg)
        scene = program.scene(arrays)
        renderer = DeferredRenderer(rcfg, style="dithered").configure_for(
            scene)
        self.dscene = DeviceScene.from_scene(scene, rcfg, device=device)
        cache = StaticBins(scene.pos, scene.ext, cfg["dynamic_entities"],
                           rcfg, renderer.spans, device=device)
        self.anim = AnimationRenderer(renderer, rcfg, static_bins=cache)
        players, directions = sun_states(mix, seed, arrays["pos"][0])
        self.players = torch.as_tensor(players, device=device)
        self.lights = torch.as_tensor(directions, device=device)
        self.F = mix["frames_per_batch"]
        self.in_flight = mix["in_flight"]
        pinned = device.type == "cuda"
        self.host = [torch.empty(self.F, dtype=torch.int64, pin_memory=pinned)
                     for _ in range(self.in_flight + 1)]
        self.copied = ([torch.cuda.Event() for _ in self.host]
                       if pinned else None)
        self.kept = harness.Reservoir(mix["sample_frames"],
                                      traffic.rng(seed, 3))
        self.attempted = 0
        self.completed: list[float] = []
        self.pixels_per_frame = rcfg.view_width * rcfg.view_height
        self.shapes = {"frames": self.F, "height": rcfg.view_height,
                       "width": rcfg.view_width,
                       "volume": rcfg.hash_volume,
                       "capacity": rcfg.bin_capacity}

    def submit(self, b: int):
        """Batch b's frames and per-frame checksums, as ``batch.Entry``'s,
        under the batch's directions."""
        players, directions = self.batch(b)
        frames = self.anim.render_states(self.dscene, players, directions,
                                         directional=True)
        return frames, frames.reshape(self.F, -1).view(torch.int64).sum(1)

    def stages(self, n: int) -> dict:
        """The directional route's stages (STAGES) on batches 0..n-1, each
        between CUDA events, in ``gbuffer_and_frames``' order; the frames
        must equal ``render_states``' or the split is not read."""
        r, ds, cache = self.anim.renderer, self.dscene, self.anim.static_bins
        cfg = r.config
        clock = harness.StageClock(ds.device, STAGES)
        for b in range(n):
            players, directions = self.batch(b)
            clock.mark()
            bins_ent, counts = batched.bin_stage(r, cache, ds, players)
            clock.mark()
            winners = batched.winner_stage(r, ds, bins_ent, counts, players)
            clock.mark()
            gbuf = trace.materialize_gbuffer(
                winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
                ds.atlas_depth, ds.atlas_normal, ds.palette, players, cfg)
            clock.mark()
            tl, inv, K = shadow_dir.direction_constants(directions, cfg)
            dot = shade.lambert_dot(gbuf.normal,
                                    tuple(tl[:, a].view(self.F, 1, 1)
                                          for a in range(3)))
            clock.mark()
            lit = shadow_cuda.trace_light_directional(
                ds.pos, ds.ext, bins_ent, counts, gbuf.y, gbuf.z,
                gbuf.entity_index, inv, K, players, cfg,
                shadow_dir.grid_max_steps(cfg))
            clock.mark()
            frames = batched.shade_stage(r, ds, gbuf, shade.factor_from_dot(
                dot, lit, cfg))
            clock.mark()
            clock.close()
            if not torch.equal(frames, self.submit(b)[0]):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n * self.F,
                **clock.ms}


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """``reference/sun.py``'s frames of the samples' (player, direction)
    states, at most ``harness.REFERENCE_PIXELS`` pixels a call."""
    if not samples:
        return []
    scene = harness.reference_scene(arrays, cell.config, device)
    view = harness.view(cell.config)
    players = torch.as_tensor(np.stack([s[0] for s in samples]),
                              dtype=torch.int32, device=device)
    directions = torch.as_tensor(np.stack([s[1] for s in samples]),
                                 dtype=torch.float32, device=device)
    step = max(1, harness.REFERENCE_PIXELS // (view.width * view.height))
    frames = torch.cat([
        sun.render_frames(scene, players[i:i + step],
                          directions[i:i + step], view, fdt,
                          cell.config["bayer"])
        for i in range(0, players.shape[0], step)])
    return list(frames.cpu().numpy())
