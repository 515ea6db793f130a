"""Still frames: ``SupersampledRenderer.render``, one client in a closed
loop.  A request is a base light; the program renders the scaled scene at
F = 1 with a full rebin on its main path (bins, ``trace.cu``, the
winner-input mode of ``shadow.cu``), box-filters it and the frame is
copied to the host, where the latency ends.  The frames compared are a
seeded uniform sample of all answered.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer, box_filter)
from pixel_art_raytracer_tpu_torch.runtime import kernels

from port_bench import harness, program, reference, traffic


class Entry:
    def __init__(self, cell, arrays, seed: int, device):
        if device.type == "cuda":
            kernels.library()
        cfg, mix = cell.config, cell.traffic
        self.s = cfg["supersample"]
        self.sr = SupersampledRenderer(program.render_config(cfg), self.s)
        self.dscene = self.sr.prepare(program.scene(arrays), device=device)
        self.config, self.seed, self.player0 = cfg, seed, arrays["pos"][0]
        self.requests = traffic.Requests(mix, cfg, seed, self.player0)
        self.kept = harness.Reservoir(mix["sample_requests"],
                                      traffic.rng(seed, 3))
        self.attempted = 0
        rcfg = self.sr.config
        self.pixels_per_frame = rcfg.view_width * rcfg.view_height
        self.shapes = {"frames": 1, "height": rcfg.view_height,
                       "width": rcfg.view_width,
                       "volume": rcfg.hash_volume,
                       "capacity": rcfg.bin_capacity}

    def render(self, light) -> np.ndarray:
        return self.sr.render(self.dscene, light).cpu().numpy()

    def warm(self) -> None:
        for _ in range(2):
            self.render(np.asarray(self.requests.spec["light_start"]))

    def run(self, window) -> list[float]:
        latencies = []
        while window.open():
            req = self.requests.next()
            t0 = time.perf_counter()
            frame = self.render(req.light)
            latencies.append(time.perf_counter() - t0)
            for _, slot in self.kept.offer(1):
                self.kept.kept[slot] = (req, frame)
            window.done(1)
        self.attempted = len(latencies)
        return latencies

    def stages(self, n: int) -> dict:
        """``render``'s stages for the mix's first ``n`` requests: the full
        rebin (``batched.bin_stage`` with no cache), ``trace.cu``, the
        winner-input mode and the box filter; the frame must equal
        ``render``'s."""
        r, ds = self.sr.renderer, self.dscene
        names = ("bins", "trace", "shade", "filter")
        clock = harness.StageClock(ds.device, names)
        players = ds.pos[:1]
        reqs = traffic.Requests(self.requests.spec, self.config, self.seed,
                                self.player0)
        for req in (reqs.next() for _ in range(n)):
            lights = torch.as_tensor(req.light * self.s, dtype=torch.int32,
                                     device=ds.device)[None]
            clock.mark()
            bins_ent, counts = batched.bin_stage(r, None, ds, players)
            clock.mark()
            winners = batched.winner_stage(r, ds, bins_ent, counts, players)
            clock.mark()
            frames = batched.shade_point_stage(r, ds, bins_ent, counts,
                                               players, winners, lights)
            clock.mark()
            frame = box_filter(frames[0], self.s)
            clock.mark()
            clock.close()
            if not np.array_equal(frame.cpu().numpy(), self.render(req.light)):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n, **clock.ms}

    def samples(self) -> list:
        return self.kept.items()

    def free(self) -> None:
        self.sr = self.dscene = None


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """The reference's frames of the sampled lights, rendered at the
    traced size and box-filtered."""
    if not samples:
        return []
    s = cell.config["supersample"]
    scene = harness.reference_scene(arrays, cell.config, device)
    player = np.asarray(arrays["pos"][0]) * s
    frames = harness.reference_frames(
        scene, np.stack([player for _ in samples]),
        np.stack([r.light * s for r, _ in samples]),
        harness.view(cell.config), fdt)
    return [reference.box_filter(f, s).cpu().numpy() for f in frames]
