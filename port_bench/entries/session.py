"""The interactive loop: ``runtime.session.Session.feed``, one client in a
closed loop.  A request is one frame's key events and mouse position; its
latency runs from the call to the frame on the host with the debug line
drawn.  ``feed`` takes the G-buffer mode: a full ``build_bins``, trace
and G-buffer, the light geometry, the point mode of ``shadow.cu`` and the
shade.  The session keeps every frame it renders, as one that may save a
GIF does; the frames compared are a seeded sample of them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models.animation import scene_with_player
from pixel_art_raytracer_tpu_torch.runtime import kernels
from pixel_art_raytracer_tpu_torch.runtime.session import Session
from pixel_art_raytracer_tpu_torch.scene import Light

from port_bench import harness, program, reference, traffic


class Entry:
    def __init__(self, cell, arrays, seed: int, device):
        if device.type == "cuda":
            kernels.library()
        cfg, self.mix = cell.config, cell.traffic
        if cfg["supersample"] != 1:
            raise ValueError("the session renders at the base size")
        self.config, self.seed = cfg, seed
        self.session = Session(program.scene(arrays),
                               Light(*self.mix["light_start"]),
                               program.render_config(cfg), device=device)
        self.player0 = arrays["pos"][0]
        self.requests = traffic.Requests(self.mix, cfg, seed, self.player0)
        self.sent: list[traffic.Request] = []
        self.first = 0
        self.attempted = 0
        self.pixels_per_frame = cfg["view_width"] * cfg["view_height"]
        self.shapes = {"frames": 1, "height": cfg["view_height"],
                       "width": cfg["view_width"]}

    def warm(self) -> None:
        for _ in range(2):
            self.session.feed([], mouse=(0, 0))
        self.first = len(self.session.frames)

    def run(self, window) -> list[float]:
        latencies = []
        while window.open():
            req = self.requests.next()
            t0 = time.perf_counter()
            self.session.feed(req.keys, mouse=req.mouse)
            latencies.append(time.perf_counter() - t0)
            self.sent.append(req)
            window.done(1)
        self.attempted = len(self.sent)
        return latencies

    def stages(self, n: int) -> dict:
        """The frame's stages for the states of the mix's first ``n``
        requests: ``build_bins`` (the full rebin), ``trace`` (trace.cu and
        the G-buffer) and ``shade`` (geometry, the shadow march, the
        shade); the frame must equal ``render_with_gbuffer``'s."""
        s = self.session
        r = s.renderer
        names = ("bins", "trace", "shade")
        clock = harness.StageClock(s.dscene.device, names)
        reqs = traffic.Requests(self.mix, self.config, self.seed,
                                self.player0)
        for req in (reqs.next() for _ in range(n)):
            scene_f = scene_with_player(s.dscene, torch.as_tensor(
                req.player, dtype=torch.int32))
            light = torch.as_tensor(req.light, dtype=torch.int32)
            clock.mark()
            bins_ent, counts = r.build_bins(scene_f)
            clock.mark()
            gbuf = r.trace(scene_f, bins_ent, counts)
            clock.mark()
            frame = r.shade(scene_f, gbuf, bins_ent, counts, light)
            clock.mark()
            clock.close()
            if not torch.equal(frame,
                               r.render_with_gbuffer(scene_f, light)[1]):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n, **clock.ms}

    def samples(self) -> list:
        """A seeded sample of the window's requests with their frames."""
        n = len(self.sent)
        k = min(self.mix["sample_requests"], n)
        pick = np.sort(traffic.rng(self.seed, 3).choice(n, k, replace=False))
        frames = self.session.frames
        return [(self.sent[i], frames[self.first + i].image) for i in pick]

    def free(self) -> None:
        self.session = None


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """The reference's frames of the sampled requests' states, each with
    the debug line from the hovered pixel's surface point to the light
    (alternative.cpp:762-772): the readout clamps the mouse into the view,
    the line starts at its unclamped x."""
    if not samples:
        return []
    v = harness.view(cell.config)
    scene = harness.reference_scene(arrays, cell.config, device)
    frames, y, z = harness.reference_frames(
        scene, np.stack([r.player for r, _ in samples]),
        np.stack([r.light for r, _ in samples]), v, fdt, with_surface=True)
    frames, y, z = frames.cpu().numpy(), y.cpu().numpy(), z.cpu().numpy()
    out = []
    for i, (req, _) in enumerate(samples):
        image = frames[i].copy()
        mx = min(max(req.mouse[0], 0), v.width - 1)
        my = min(max(req.mouse[1], 0), v.height - 1)
        lx, ly, lz = (int(c) for c in req.light)
        reference.draw_line(image, req.mouse[0],
                            v.height - int(y[i, my, mx] + z[i, my, mx]),
                            lx, v.height - (ly + lz), (255, 0, 0))
        out.append(image)
    return out
