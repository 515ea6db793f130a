"""Performance metrics and timing.

Counterpart of ``pixel_art_raytracer_tpu/utils/metrics.py``.  The
reference's only instrumentation is a per-frame wall-clock print
(``SDL_GetTicks`` delta, alternative.cpp:815-817).  Here: rays/s accounting
(primary + shadow rays per frame, matching the workload definition in
BASELINE.md), a timer that waits for the card, and an optional
``torch.profiler`` trace hook.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time

import torch


@dataclasses.dataclass
class RenderStats:
    frames: int
    height: int
    width: int
    seconds: float
    shadow_rays: bool = True

    @property
    def rays_per_frame(self) -> int:
        per = self.height * self.width
        return per * 2 if self.shadow_rays else per

    @property
    def mrays_per_sec(self) -> float:
        return self.frames * self.rays_per_frame / self.seconds / 1e6

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds

    def to_json(self) -> str:
        return json.dumps({
            "frames": self.frames, "height": self.height, "width": self.width,
            "seconds": round(self.seconds, 6),
            "mrays_per_sec": round(self.mrays_per_sec, 3),
            "frames_per_sec": round(self.frames_per_sec, 3),
        })


def _tensors(out) -> list[torch.Tensor]:
    """The tensors of ``out``, in the JAX package's leaf order: a tensor,
    or tuples (named ones included), lists and dicts (by sorted key) of
    them, nested; other leaves are skipped."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for leaf in out for t in _tensors(leaf)]
    return []


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``.  CPU
    tensors are complete when an eager op returns."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def checksummed(fn):
    """Wrap ``fn`` so each tensor output reduces to one scalar on its
    device: integer outputs summed in int32 (wrapping, as the JAX
    package's), others summed in their dtype.

    Timing the wrapper pays the full cost of computing every output element
    while only scalars leave the device.
    """

    def _sum(t: torch.Tensor) -> torch.Tensor:
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            return t.sum()
        return t.sum(dtype=torch.int32)

    def wrapped(*args):
        return [_sum(t) for t in _tensors(fn(*args))]

    return wrapped


def time_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Time a device function: returns ``(best_seconds_per_call,
    last_output)``.

    Each call is timed on the host clock up to ``torch.cuda.synchronize()``
    on the devices of its output tensors, so the time is the card's work,
    not its enqueue.  The warm-up calls absorb kernel builds and caches.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
        _synchronize(out)
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def profiler_trace(logdir):
    """``torch.profiler`` around a block, its Chrome trace written to
    ``<logdir>/trace.json`` (CPU activity, and CUDA activity when PyTorch
    sees a card); a no-op for ``logdir=None``."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path / "trace.json"))
