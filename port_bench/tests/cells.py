"""Small versions of the benchmark's cells for CPU tests: the same
generators, mixes and entries at a 120x80x80 view (config 5: 300 boxes,
s = 2), every frame of the run kept for the comparison."""

from __future__ import annotations

import json
import time

import torch

from port_bench import harness, spec

CPU = torch.device("cpu")


def full_cell(name: str) -> spec.Cell:
    """The cell ``<config>.<traffic>``, listed in BENCHMARK.json or not."""
    bench = json.loads(spec.BENCHMARK.read_text())
    return spec.make_cell(name, *name.split("."), 1, bench)


def small_cell(name: str, **mix) -> spec.Cell:
    """:func:`full_cell` cut to the small size."""
    cell = full_cell(name)
    cell.config = dict(cell.config, view_width=120, view_height=80,
                       view_length=80)
    if cell.config_name == "config5":
        cell.config["boxes"] = 300
    traffic = dict(cell.traffic)
    if traffic["entry"] == "batch":
        traffic.update(frames_per_batch=4, prestaged_batches=3,
                       sample_frames=64)
    else:
        traffic.update(sample_requests=4)
        if cell.config_name == "graybox":
            traffic.update(light_start=[60, 60, 40], light_low=[20, 20, 0],
                           light_high=[100, 80, 70],
                           player_high=[100, 60, 60])
    traffic.update(mix)
    cell.traffic = traffic
    return cell


def run_small(name: str, seconds: float = 0.5, trace: bool = False,
              control=None, **mix):
    """``harness.run`` of the small cell on the CPU: ``(record, setup_s,
    peak, compared)``."""
    return harness.run(small_cell(name, **mix), 12345, seconds, trace, CPU,
                       time.perf_counter(), control)
