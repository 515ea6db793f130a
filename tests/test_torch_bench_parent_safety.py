"""The benchmark's readers against a program that lacks what they read.

Traced runs of every cell are made with the newest benchmark files on an
older program too, so a reader has to give nothing, and never raise,
where its stage, span, counter key or attribute is missing.  For every
cell of ``BENCHMARK.json``, every per-layer reader that applies to it is
called on a record with no trace, with a trace but no split, and with a
split that was not read (``split_ok`` False), and on counters without the
multi-light mode's keys; the directional marched share gives nothing
without its counter; every per-layer metric lists its cells.  And the
multi-light cell runs correct on a program without the multi-light stage
(its G-buffer route), leaving its two new metrics out of the line.
"""

from __future__ import annotations

import json
import numbers
import time

import pytest
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.ops import shadow_cuda
from port_bench import harness, profiling, run, spec
from port_bench.tests.cells import CPU, small_cell

BENCH = json.loads(spec.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SHAPES = {"frames": 64, "height": 320, "width": 480, "volume": 768,
          "capacity": 8}
RECORDS = ("no trace", "no split", "split not read")


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record(cell: str, kind: str) -> harness.RunRecord:
    trace = None if kind == "no trace" else profiling.Trace([], [], 2.0)
    stages = {"split_ok": False} if kind == "split not read" else None
    return harness.RunRecord(cell, 3, 12, 1.0, [], 100, dict(SHAPES), trace,
                             0, stages)


class OlderCounters:
    """Counters of a program without the multi-light mode."""

    def read(self):
        return {"direct_pixels": 0, "max_starts": 2, "max_list": 9,
                "staged_entries": 10, "slab_tests": 40,
                "shade_slab_tests": 600, "shade_marched_pixels": 20,
                "shade_pixels": 24, "dir_pixels": 8, "dir_shade_pixels": 8}


@pytest.mark.parametrize("kind", RECORDS)
@pytest.mark.parametrize("cell", CELLS)
def test_readers_give_nothing_or_a_number_and_never_raise(cell, kind,
                                                          monkeypatch):
    for counters in (shadow_cuda.counters, OlderCounters()):
        monkeypatch.setattr(shadow_cuda, "counters", counters)
        for m in spec.load_cell(cell).per_layer:
            v = spec.metric_reader(m["name"])(record(cell, kind))
            assert v is None or isinstance(v, numbers.Real), m["name"]


def test_every_per_layer_metric_lists_its_cells():
    for m in BENCH["per_layer"]:
        assert m.get("workloads"), m["name"]
        assert set(m["workloads"]) <= set(CELLS), m["name"]


def test_marched_share_needs_its_counter(monkeypatch):
    """``dir_marched_share.batch`` on a traced record gives nothing where
    the program has no counters, none of ``dir_marched_pixels`` (a program
    before the directional live set) or no directional frames, else the
    marched share in %; and nothing on a run that was not traced."""
    read = spec.metric_reader("dir_marched_share.batch")
    traced = record("config4.sun64", "no split")

    class Counters(OlderCounters):
        def __init__(self, **more):
            self.more = more

        def read(self):
            return {**super().read(), **self.more}

    monkeypatch.setattr(shadow_cuda, "counters", OlderCounters())
    assert read(traced) is None
    monkeypatch.setattr(shadow_cuda, "counters",
                        Counters(dir_marched_pixels=0, dir_shade_pixels=0))
    assert read(traced) is None
    monkeypatch.setattr(shadow_cuda, "counters",
                        Counters(dir_marched_pixels=2))
    assert read(traced) == pytest.approx(25.0)
    assert read(record("config4.sun64", "no trace")) is None
    monkeypatch.delattr(shadow_cuda, "counters")
    assert read(traced) is None


def older_winner_inputs(renderer, lights, directional):
    """The route rule of a program without the multi-light mode."""
    if directional:
        return lights.dim() == 2
    return (lights.dim() == 2 and renderer.style == "reference"
            and not renderer.fuse_trace_shadow)


def test_multi_light_cell_runs_on_a_program_without_its_stage(monkeypatch):
    monkeypatch.setattr(harness, "STAGE_RUNS", 2)
    monkeypatch.setattr(batched, "winner_inputs", older_winner_inputs)
    monkeypatch.delattr(batched, "shade_lights_stage")
    monkeypatch.setattr(shadow_cuda, "counters", OlderCounters())
    c = small_cell("graybox_lights3.orbit3x64", frames_per_batch=2,
                   prestaged_batches=2, sample_frames=4,
                   light={"kind": "orbits",
                          "centers": [[40, 30, 20], [10, 30, 20],
                                      [40, 30, 50]],
                          "radius": 10, "period": 256})
    c.config.update(view_width=64, view_height=48, view_length=64)
    record_, setup_s, peak, compared = harness.run(
        c, 2 ** 33 + 5, 1.0, True, CPU, time.perf_counter())
    out = run.result(c, record_, setup_s, peak, compared, CPU, 1)
    assert out["correct"] is True
    assert record_.stages == {"split_ok": False}
    assert not {"lights_roofline.batch",
                "lights_slab_tests_per_pixel.batch"} & set(out["metrics"])
