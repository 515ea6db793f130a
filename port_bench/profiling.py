"""The device trace of a traced window, read from ``torch.profiler``'s
events in memory (no trace file is written).

Device activities are the events the profiler records on the card
(kernels, copies, fills); the busy time is the length of the union of
their intervals and the idle share ``1 - busy / span`` over the span from
the first activity's start to the last one's end (the arithmetic of the
program's ``prof_paths``).  An idle gap is named by what the host was
doing at its middle: the innermost operator (not a CUDA runtime call)
whose interval holds that instant, or ``python`` where none does.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
import warnings

import torch

TOP = 10
NAME_CHARS = 96


@dataclasses.dataclass
class Trace:
    activities: list[tuple[float, float, str]]  # (start_s, end_s, name)
    host_ops: list[tuple[float, float, str]]    # operators, by start
    window_s: float

    @property
    def busy_s(self) -> float:
        return busy(self.activities)

    @property
    def span_s(self) -> float:
        if not self.activities:
            return 0.0
        return self.activities[-1][1] - self.activities[0][0]

    def device_ops(self) -> list[list]:
        """The device operations with the most time: [name, seconds]."""
        by_name = collections.Counter()
        for s, e, name in self.activities:
            by_name[name[:NAME_CHARS]] += e - s
        return [[n, t] for n, t in by_name.most_common(TOP)]

    def idle_gaps(self) -> list[list]:
        """The idle time between device activities, summed by the host
        operation running at each gap's middle: [name, seconds]."""
        starts = [op[0] for op in self.host_ops]
        by_name = collections.Counter()
        end = None
        for s, e, _ in self.activities:
            if end is not None and s > end:
                by_name[host_op_at(self.host_ops, starts,
                                   (s + end) / 2)] += s - end
            end = e if end is None else max(end, e)
        return [[n, t] for n, t in by_name.most_common(TOP)]


def busy(acts) -> float:
    """Length of the union of the activities' intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in acts:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def host_op_at(ops, starts, t: float, lookback: int = 256) -> str:
    """The innermost of ``ops`` (sorted by start) whose interval holds
    ``t``: the one that started last."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(ops[max(0, i - lookback):i]):
        if e >= t:
            return name
    return "python"


class Tracer:
    """``torch.profiler`` over a window that an entry's loop opens and
    closes (CPU and CUDA activities)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.start_s = None

    def warm(self, device) -> None:
        """Start and stop a profiler once, outside the window: the first
        start in a process takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)

    def start(self) -> None:
        t = time.perf_counter()
        warnings.filterwarnings("ignore", "Profiler clears events",
                                UserWarning)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.prof.stop()

    def trace(self) -> Trace:
        cuda = torch.autograd.DeviceType.CUDA
        acts, ops = [], []
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if ev.device_type() == cuda:
                if not ev.is_user_annotation():
                    acts.append((s, e, ev.name()))
            elif not ev.name().startswith("cuda"):
                ops.append((s, e, ev.name()))
        acts.sort()
        ops.sort()
        return Trace(acts, ops, self.t1 - self.t0)
