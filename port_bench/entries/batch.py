"""Batched renders: ``AnimationRenderer.render_states`` on a ``StaticBins``
cache of the scene (the player the one dynamic entity), the program's main
path: bins merge, ``trace.cu``, then ``shadow.cu``'s winner-input mode.
With a ``supersample`` factor s the scene is the program's scaled scene
(``SupersampledRenderer.prepare``) and frames are delivered at the traced
size.

The loop is closed with ``in_flight`` batches in flight: the host submits
batch b and the copy of its per-frame checksums into a pinned host
buffer, then waits for batch b - 1's copy (an event recorded after it,
so not for batch b); frames stay in device memory.  Once the window closes no batch is
submitted, and the window ends when the last one submitted has been read.
Frames kept for the comparison are a seeded uniform sample of all frames
rendered, copied on the card as their batch is submitted.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer, scale_scene)
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels

from port_bench import harness, program, traffic


class Entry:
    def __init__(self, cell, arrays, seed: int, device):
        if device.type == "cuda":
            kernels.library()
        cfg, mix = cell.config, cell.traffic
        s = cfg["supersample"]
        base = program.render_config(cfg)
        scene = program.scene(arrays)
        if s > 1:
            sr = SupersampledRenderer(base, s)
            self.dscene = sr.prepare(scene, device=device)
            renderer, rcfg = sr.renderer, sr.config
            scene = scale_scene(scene, s)
        else:
            renderer = DeferredRenderer(base).configure_for(scene)
            self.dscene = DeviceScene.from_scene(scene, base, device=device)
            rcfg = base
        cache = StaticBins(scene.pos, scene.ext, cfg["dynamic_entities"],
                           rcfg, renderer.spans, device=device)
        self.anim = AnimationRenderer(renderer, rcfg, static_bins=cache)
        players, lights = traffic.batch_states(mix, cfg, seed,
                                               arrays["pos"][0])
        self.players = torch.as_tensor(players, device=device)
        self.lights = torch.as_tensor(lights, device=device)
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

    def batch(self, b: int):
        b %= self.players.shape[0]
        return self.players[b], self.lights[b]

    def submit(self, b: int):
        """Batch b's frames and per-frame checksums, on the card: the sum,
        modulo 2**64, of each frame's bytes read as 64-bit words (a frame
        of the cells' sizes is a whole number of words)."""
        players, lights = self.batch(b)
        frames = self.anim.render_states(self.dscene, players, lights)
        return frames, frames.reshape(self.F, -1).view(torch.int64).sum(1)

    def deliver(self, b: int, checksums):
        """Start the copy of batch b's checksums into a pinned host buffer
        of a ring of ``in_flight + 1``; returns the event that completes
        with the copy (None off the card, where the copy is done)."""
        i = b % len(self.host)
        self.host[i].copy_(checksums, non_blocking=True)
        if not checksums.is_cuda:
            return None
        self.copied[i].record()
        return self.copied[i]

    def warm(self) -> None:
        for b in range(2):
            done = self.deliver(b, self.submit(b)[1])
            if done is not None:
                done.synchronize()

    def run(self, window) -> list:
        pending = collections.deque()
        b = 0
        while True:
            issuing = window.open()
            if issuing:
                frames, checksums = self.submit(b)
                players, lights = self.batch(b)
                for f, slot in self.kept.offer(self.F):
                    self.kept.kept[slot] = (players[f], lights[f],
                                            frames[f].clone())
                pending.append(self.deliver(b, checksums))
                b += 1
            if not pending:
                break
            if issuing and len(pending) < self.in_flight:
                continue
            done = pending.popleft()
            if done is not None:
                done.synchronize()
            window.done(self.F)
            self.completed.append(time.perf_counter())
        self.attempted = b
        return []

    def stages(self, n: int) -> dict:
        """The main path's stages on batches 0..n-1, each between CUDA
        events, in the order ``render_states_batched`` calls them; the
        frames must equal ``render_states``' or the split is not read."""
        r, ds, cache = self.anim.renderer, self.dscene, self.anim.static_bins
        names = ("bins", "trace", "shade")
        clock = harness.StageClock(ds.device, names)
        for b in range(n):
            players, lights = self.batch(b)
            clock.mark()
            bins_ent, counts = batched.bin_stage(r, cache, ds, players)
            clock.mark()
            winners = batched.winner_stage(r, ds, bins_ent, counts, players)
            clock.mark()
            frames = batched.shade_point_stage(r, ds, bins_ent, counts,
                                               players, winners, lights)
            clock.mark()
            clock.close()
            if not torch.equal(frames, self.submit(b)[0]):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n * self.F,
                **clock.ms}

    def samples(self) -> list:
        return [(p.cpu().numpy(), l.cpu().numpy(), f.cpu().numpy())
                for p, l, f in self.kept.items()]

    def free(self) -> None:
        self.anim = self.dscene = self.kept = None
        self.players = self.lights = None


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """The reference's frames of the samples' (player, light) states."""
    if not samples:
        return []
    scene = harness.reference_scene(arrays, cell.config, device)
    frames = harness.reference_frames(
        scene, np.stack([s[0] for s in samples]),
        np.stack([s[1] for s in samples]), harness.view(cell.config), fdt)
    return list(frames.cpu().numpy())
