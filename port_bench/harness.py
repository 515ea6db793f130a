"""One run of a cell: set-up, the measured window, the traced split of the
stages, and the comparison with the reference.

An entry (``entries/<name>.py``) holds the program for one kind of mix:
``Entry(cell, arrays, seed, device)`` builds and loads it (set-up),
``warm()`` runs every shape the mix uses once, ``run(window)`` drives the
closed loop until the window closes, ``stages(n)`` times the entry's
stages on the mix's first ``n`` requests with CUDA events (traced runs,
before the window and the profiler), ``samples()`` gives the outputs kept
for the comparison, and the module's ``expected(cell, arrays, samples,
device, fdt)`` the reference's frames of the same states.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import numpy as np
import torch

from . import profiling, reference

# The traced part of a traced run's window: its last seconds.
TRACE_SECONDS = 2.0
# Requests or batches the traced run drives stage by stage.
STAGE_RUNS = 8
# The most pixels the reference renders in one call.
REFERENCE_PIXELS = 1 << 24


class Window:
    """The measured window: ``open()`` before each request says whether to
    submit it; with a tracer, its last ``trace_s`` seconds are traced."""

    def __init__(self, seconds: float, tracer=None,
                 trace_s: float = TRACE_SECONDS):
        self.seconds = seconds
        self.tracer = tracer
        self.trace_s = trace_s
        self.trace_from = max(0.0, seconds - trace_s)
        self.tracing = False
        self.units = 0          # frames or requests completed
        self.traced_units = 0   # ... of them while tracing
        self.t0 = self.t1 = None

    def begin(self) -> None:
        self.t0 = time.perf_counter()

    def open(self) -> bool:
        """Whether to submit the next request: until ``seconds`` have
        passed, and while tracing until ``trace_s`` have been traced."""
        now = time.perf_counter()
        if self.tracer is not None and not self.tracing \
                and now - self.t0 >= self.trace_from:
            self.tracer.start()
            self.tracing = True
            now = time.perf_counter()
        if self.tracing and now - self.tracer.t0 < self.trace_s:
            return True
        return now - self.t0 < self.seconds

    def done(self, units: int) -> None:
        self.units += units
        if self.tracing:
            self.traced_units += units

    def end(self) -> None:
        self.t1 = time.perf_counter()
        if self.tracing:
            self.tracer.stop()

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


class Reservoir:
    """A uniform sample of ``k`` of the outputs offered, drawn from a seeded
    generator: output n replaces a kept one with probability k / (n + 1)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.kept: list = [None] * k
        self.offered = 0

    def offer(self, count: int) -> list[tuple[int, int]]:
        """Offer ``count`` outputs; returns ``(index among them, slot)`` for
        each that is to be kept, in order (a later one may take the same
        slot)."""
        n = self.offered + np.arange(count)
        slot = np.where(n < self.k, n, self.rng.integers(0, n + 1))
        self.offered += count
        return [(int(i), int(slot[i])) for i in np.flatnonzero(slot < self.k)]

    def items(self) -> list:
        return [x for x in self.kept if x is not None]


def view(config: dict) -> reference.View:
    """The reference's view of a configuration, at its traced size."""
    v = reference.View(
        config["view_width"], config["view_height"], config["view_length"],
        config["bin_size"], config["bin_capacity"], config["sprite_width"],
        config["sprite_height"], config["ambient"],
        tuple(config["background"]), config["early_exit"])
    return v.scaled(config["supersample"])


def reference_scene(arrays: dict, config: dict, device) -> dict:
    """The scene arrays as the reference reads them, scaled by the
    configuration's supersample factor, on ``device``."""
    scaled = reference.scale_scene(arrays, config["supersample"])
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in scaled.items()}


def reference_frames(scene: dict, players, lights, v: reference.View,
                     fdt, with_surface=False):
    """``reference.render_frames`` in chunks of at most
    REFERENCE_PIXELS pixels, on the scene's device; players and lights
    (F, 3) int32."""
    dev = scene["pos"].device
    players = torch.as_tensor(np.asarray(players), dtype=torch.int32,
                              device=dev)
    lights = torch.as_tensor(np.asarray(lights), dtype=torch.int32,
                             device=dev)
    step = max(1, REFERENCE_PIXELS // (v.width * v.height))
    parts = [reference.render_frames(scene, players[i:i + step],
                                     lights[i:i + step], v, fdt,
                                     with_surface)
             for i in range(0, players.shape[0], step)]
    if with_surface:
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def differing_pixels(got: list[np.ndarray], want: list[np.ndarray]) -> int:
    """Pixels whose colour differs in any channel, over the frames; a
    frame of another shape differs everywhere."""
    n = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            n += w.shape[0] * w.shape[1]
        else:
            n += int((g != w).any(axis=-1).sum())
    return n


class StageClock:
    """Times consecutive stages: ``mark()`` before the first and after
    each, ``close()`` after the last adds each stage's time to ``ms``
    (CUDA events on the card, the host clock elsewhere)."""

    def __init__(self, device, names):
        self.device = device
        self.names = names
        self.ms = dict.fromkeys(names, 0.0)
        self.marks = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def close(self) -> None:
        sync(self.device)
        for name, a, b in zip(self.names, self.marks, self.marks[1:]):
            self.ms[name] += (a.elapsed_time(b) if self.device.type == "cuda"
                              else (b - a) * 1e3)
        self.marks = []


@dataclasses.dataclass
class RunRecord:
    """What a run measured, for the metric readers."""

    cell: str
    attempted: int
    units: int                    # frames (batches) or requests completed
    window_s: float
    latencies_s: list[float]
    pixels_per_frame: int         # traced pixels
    shapes: dict                  # frames, height, width, volume, capacity
    trace: profiling.Trace | None = None
    traced_units: int = 0
    stages: dict | None = None    # stage -> total ms, "runs", "frames"
    completed: list[float] = dataclasses.field(default_factory=list)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control=None):
    """Set up, warm, measure, split (traced runs) and compare.  Returns
    ``(record, setup_s, peak_bytes, compared)``, ``compared`` the numbers
    compared with their limits.  With ``control`` (a float dtype), the
    reference computed in it is compared too, in the program's place:
    the control, which has to fail the comparison (``compared``'s
    ``control_differing_pixels``)."""
    t0 = time.perf_counter()
    arrays = cell.scene()
    t1 = time.perf_counter()
    ent = cell.entry().Entry(cell, arrays, seed, device)
    t2 = time.perf_counter()
    ent.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: imports and CUDA {t0 - t_start:.3f}, "
          f"scene {t1 - t0:.3f}, program {t2 - t1:.3f} (kernels, scene on "
          f"the card, caches), warm-up {t_start + setup_s - t2:.3f}",
          file=sys.stderr)

    stages = tracer = None
    if trace:
        stages = ent.stages(STAGE_RUNS)
        tracer = profiling.Tracer()
        tracer.warm(device)
    window = Window(seconds, tracer)
    gc.collect()
    gc.freeze()
    window.begin()
    latencies = ent.run(window)
    window.end()
    gc.unfreeze()
    record = RunRecord(
        cell.name, ent.attempted, window.units, window.elapsed, latencies,
        ent.pixels_per_frame, ent.shapes,
        tracer.trace() if tracer else None, window.traced_units, stages,
        getattr(ent, "completed", []))
    if tracer:
        print(f"profiler: started in {tracer.start_s:.3f} s, traced "
              f"{record.trace.window_s:.3f} s, {len(record.trace.activities)}"
              f" device activities, {window.traced_units} units",
              file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    samples = ent.samples()
    got = [np.asarray(s[-1]) for s in samples]
    ent.free()
    del ent
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    expected = cell.entry().expected
    want = expected(cell, arrays, samples, device, torch.float32)
    compared = {"frames_compared": len(got),
                "differing_pixels": differing_pixels(got, want)}
    if control is not None:
        compared["control_differing_pixels"] = differing_pixels(
            expected(cell, arrays, samples, device, control), want)
    return record, setup_s, peak, compared


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def end_to_end(record: RunRecord, setup_s: float) -> dict:
    """The end-to-end values the harness measures itself."""
    lat = sorted(record.latencies_s)
    values = {"setup_s": setup_s}
    if record.units and not lat:
        values["mrays_per_s"] = (2 * record.pixels_per_frame * record.units
                                 / record.window_s / 1e6)
    if lat:
        values["latency_p50_ms"] = statistics.median(lat) * 1e3
        values["latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    return values

