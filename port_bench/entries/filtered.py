"""Batched renders delivered as published: ``supersample.filtered_states``
(the body of ``SupersampledRenderer.render_states``) on a ``StaticBins``
cache of the scaled scene (the player the one dynamic entity), the
program's main path at the traced size (bins merge, ``trace.cu``,
``shadow.cu``'s winner-input mode), then the box filter to the base size
(on the card one launch of ``csrc/filter.cu``), in one ``batch`` span.

The closed loop, the per-frame checksums and the sample are the batch
entry's (``entries/batch.py``, loaded by path), and so is the renderer,
configured for the scaled scene: only the call that renders a batch
differs, so the frames checksummed, kept and compared are the filtered
ones.  ``pixels_per_frame`` stays the traced size, so
``mrays_per_s`` counts the rays that the unfiltered batch cells count.
"""

from __future__ import annotations

import numpy as np
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.supersample import (
    box_filter, filtered_states)
from pixel_art_raytracer_tpu_torch.ops import filter_cuda

from port_bench import harness, reference, spec

batch = spec.load_module(spec.ROOT / "entries" / "batch.py")


class Entry(batch.Entry):
    def __init__(self, cell, arrays, seed: int, device):
        super().__init__(cell, arrays, seed, device)
        self.factor = cell.config["supersample"]
        self.shapes["supersample"] = self.factor

    def submit(self, b: int):
        """Batch b's filtered frames and their per-frame checksums, on the
        card (``entries/batch.py``'s)."""
        players, lights = self.batch(b)
        frames = filtered_states(self.anim.renderer, self.factor,
                                 self.dscene, players, lights,
                                 self.anim.static_bins)
        return frames, frames.reshape(self.F, -1).view(torch.int64).sum(1)

    def stages(self, n: int) -> dict:
        """The main path's stages on batches 0..n-1, each between CUDA
        events, in the order ``render_states`` calls them: bins, trace,
        shade, and the filter, which on the card has to be one launch of
        the kernel; the frames must equal ``filtered_states``' or the split
        is not read."""
        r, ds, cache = self.anim.renderer, self.dscene, self.anim.static_bins
        names = ("bins", "trace", "shade", "filter")
        clock = harness.StageClock(ds.device, names)
        for b in range(n):
            players, lights = self.batch(b)
            clock.mark()
            bins_ent, counts = batched.bin_stage(r, cache, ds, players)
            clock.mark()
            winners = batched.winner_stage(r, ds, bins_ent, counts, players)
            clock.mark()
            traced = batched.shade_point_stage(r, ds, bins_ent, counts,
                                               players, winners, lights)
            clock.mark()
            launched = filter_cuda.filter_launches
            frames = box_filter(traced, self.factor)
            clock.mark()
            clock.close()
            if filter_cuda.filter_launches - launched != int(frames.is_cuda) \
                    or not torch.equal(frames, self.submit(b)[0]):
                return {"split_ok": False}
        return {"split_ok": True, "runs": n, "frames": n * self.F,
                **clock.ms}


def expected(cell, arrays, samples, device, fdt) -> list[np.ndarray]:
    """The reference's frames of the samples' (player, light) states,
    rendered at the traced size and box-filtered."""
    if not samples:
        return []
    scene = harness.reference_scene(arrays, cell.config, device)
    frames = harness.reference_frames(
        scene, np.stack([x[0] for x in samples]),
        np.stack([x[1] for x in samples]), harness.view(cell.config), fdt)
    s = cell.config["supersample"]
    return [reference.box_filter(f, s).cpu().numpy() for f in frames]
