"""``prof_paths``: device activities read from an exported chrome trace, and
their busy time as the union of their intervals; ``time_kernels`` refuses
to run without a card."""

import json

import pytest
import torch

from pixel_art_raytracer_tpu_torch import prof_paths


def test_device_activities_keep_device_events_only(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "ts": 30, "dur": 10, "name": "b"},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100, "name": "op"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 5, "dur": 2,
         "name": "cudaLaunchKernel"},
        {"ph": "X", "cat": "gpu_memset", "ts": 12, "dur": 6, "name": "m"},
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 5, "name": "a"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 50, "dur": 1, "name": "c"},
        {"ph": "f", "cat": "ac2g", "ts": 10, "name": "flow"},
    ]}))
    assert prof_paths.device_activities(trace) == [
        (10, 15, "a"), (12, 18, "m"), (30, 40, "b"), (50, 51, "c")]


@pytest.mark.parametrize("acts, busy", [
    ([], 0.0),
    ([(0, 10, "a")], 10.0),
    ([(0, 10, "a"), (20, 25, "b")], 15.0),          # a gap is idle
    ([(0, 10, "a"), (5, 12, "b")], 12.0),           # overlap counts once
    ([(0, 10, "a"), (2, 4, "b"), (8, 15, "c")], 15.0),  # nested
])
def test_busy_time_is_the_union_of_intervals(acts, busy):
    assert prof_paths.busy_us(acts) == busy


def test_time_kernels_refuses_without_a_card(monkeypatch):
    """The kernel timer measures the card or nothing."""
    from pixel_art_raytracer_tpu_torch import time_kernels
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_kernels.main("tree")
