"""BASELINE config 5 as published (``port_bench/configs/config5_1024``):
the configuration and its mix are config 5's and ``sweep64``'s but for the
filter; the small cell (a 120x80 base view, 300 boxes, s = 2, F = 4)
through ``harness.run`` is correct, with and without the traced split, and
its bfloat16 control is not; the filter roofline's reader reads its
number and nothing without its inputs."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from port_bench import bounds_filter, harness, run, spec
from port_bench.tests.cells import CPU, small_cell



@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name):
    return json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())


def test_config_is_config5_delivered_filtered():
    got, base = config("config5_1024"), config("config5")
    differ = {k for k in got.keys() | base.keys() if got.get(k) != base.get(k)}
    assert differ == {"batch_box_filter", "reduced", "source", "deployment"}
    assert got["batch_box_filter"] is True and got["reduced"] == {}
    small = dict(got, boxes=40)
    a = spec.load_module(spec.ROOT / "configs" / "config5_1024.py").scene(
        small)
    b = spec.load_module(spec.ROOT / "configs" / "config5.py").scene(small)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_mix_is_sweep64_through_the_filtered_entry():
    read = lambda n: json.loads(  # noqa: E731
        (spec.ROOT / "traffic" / f"{n}.json").read_text())
    got, base = read("filtered64"), read("sweep64")
    assert {k for k in got if got[k] != base[k]} == {"why", "entry"}
    assert got["entry"] == "filtered"


def cell():
    # The light orbits inside the small view: a plain march from the
    # published centre crosses the whole grid.
    c = small_cell("config5_1024.filtered64", frames_per_batch=2,
                   prestaged_batches=2, sample_frames=8, light={
                       "kind": "orbit", "centers": [[32, 40, 30]],
                       "radius": 10, "period": 256})
    c.config.update(view_width=64, view_height=48, view_length=64, boxes=60)
    return c


# The window's seconds: a batch takes ~0.16 s here alone and several times
# that beside the suite's other workers, and the run has to complete at
# least two batches (4 frames) for the sample to span more than one.
WINDOW_S = 2.0


def run_cell(trace: bool, control=None):
    c = cell()
    record, setup_s, peak, compared = harness.run(
        c, 2 ** 31 + 777, WINDOW_S, trace, CPU, time.perf_counter(),
        control)
    return record, compared, run.result(c, record, setup_s, peak, compared,
                                        CPU, int(trace))


@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_run_is_correct(trace, monkeypatch):
    monkeypatch.setattr(harness, "STAGE_RUNS", 2)
    record, compared, out = run_cell(
        trace, None if trace else torch.bfloat16)
    assert out["correct"] is True
    assert out["compared"]["frames_compared"]["value"] >= 4
    assert record.pixels_per_frame == 128 * 96  # the traced size
    if trace:
        assert record.stages["split_ok"]
        assert set(record.stages) >= {"bins", "trace", "shade", "filter"}
        assert "filter_roofline.batch" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "mrays_per_s"}
        assert compared["control_differing_pixels"] > 0


def test_altered_frames_are_caught(monkeypatch):
    real = batched.shade_point_stage

    def altered(*args, **kw):
        frames = real(*args, **kw).clone()
        frames[..., :2, :2, :] ^= 4  # one filtered pixel a frame
        return frames

    monkeypatch.setattr(batched, "shade_point_stage", altered)
    assert run_cell(False)[2]["correct"] is False


def record(stages, shapes):
    return harness.RunRecord("config5_1024.filtered64", 3, 12, 1.0, [], 100,
                             shapes, None, 0, stages)


BATCH = {"frames": 64, "height": 2048, "width": 2048, "volume": 5408,
         "capacity": 8, "supersample": 2}
STAGES = {"split_ok": True, "runs": 2, "frames": 128, "bins": 1.0,
          "trace": 2.0, "shade": 6.5, "filter": 0.8}
READ = spec.metric_reader("filter_roofline.batch")


def test_reader_reads_its_number():
    # Each traced byte read once, each filtered byte written once.
    bound = (64 * 2048 * 2048 * 3 * 5 / 4) / 3.35e12
    assert bounds_filter.filter_bound_s(64, 2048, 2048, 2) == \
        pytest.approx(bound)
    assert READ(record(STAGES, BATCH)) == pytest.approx(
        100 * bound * 2 / 0.8e-3)


@pytest.mark.parametrize("case", ["no split", "failed split", "no filter",
                                  "no factor"])
def test_reader_without_its_inputs_returns_nothing(case):
    stages, shapes = STAGES, BATCH
    if case == "no split":
        stages = None
    elif case == "failed split":
        stages = {"split_ok": False}
    elif case == "no filter":
        stages = {k: v for k, v in STAGES.items() if k != "filter"}
    else:  # a batch entry without the filter
        shapes = {k: v for k, v in BATCH.items() if k != "supersample"}
    assert READ(record(stages, shapes)) is None
