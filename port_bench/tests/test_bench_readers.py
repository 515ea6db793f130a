"""The trace arithmetic, the bounds and the per-layer readers on made-up
records: each reads its number, and a reader with nothing to read
returns nothing."""

from __future__ import annotations

import pytest

from port_bench import bounds, harness, profiling, spec


def record(trace=None, stages=None, traced_units=0):
    return harness.RunRecord(
        "x", 10, 640, 1.0, [], 100,
        {"frames": 64, "height": 320, "width": 480, "volume": 768,
         "capacity": 8}, trace, traced_units, stages)


TRACE = profiling.Trace(
    activities=[(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1")],
    host_ops=[(1.9, 3.5, "aten::outer"), (2.2, 2.8, "aten::inner")],
    window_s=5.0)
STAGES = {"split_ok": True, "runs": 2, "frames": 128, "bins": 3.2,
          "trace": 0.5, "shade": 1.0}


def test_busy_span_and_breakdown():
    assert TRACE.busy_s == pytest.approx(3.0)
    assert TRACE.span_s == pytest.approx(4.0)
    assert TRACE.device_ops() == [["k1", 2.0], ["k2", 1.5]]
    assert TRACE.idle_gaps() == [["aten::inner", 1.0]]
    assert profiling.host_op_at(TRACE.host_ops, [1.9, 2.2], 3.2) == \
        "aten::outer"
    assert profiling.host_op_at(TRACE.host_ops, [1.9, 2.2], 4.5) == "python"


def test_readers_read_their_numbers():
    r = record(TRACE, STAGES, traced_units=3)
    read = {m["name"]: spec.metric_reader(m["name"])(r)
            for m in json_per_layer()}
    assert read["launches_per_frame.batch"] == pytest.approx(1.0)
    assert read["device_idle.batch"] == pytest.approx(25.0)
    assert read["device_idle.frame"] == pytest.approx(25.0)
    assert read["bins_ms_per_frame.batch"] == pytest.approx(3.2 / 128)
    assert read["bins_ms.frame"] == pytest.approx(3.2 / 128)
    trace_bound = bounds.trace_bound_s(64, 320, 480, 768, 8)
    assert read["trace_roofline.batch"] == pytest.approx(
        100 * trace_bound * 2 / 0.5e-3)
    assert read["shade_roofline.batch"] == pytest.approx(
        100 * bounds.shade_bound_s(64, 320, 480, 768, 8) * 2 / 1e-3)


def test_readers_with_nothing_to_read_return_nothing():
    for r in (record(), record(stages={"split_ok": False})):
        for m in json_per_layer():
            assert spec.metric_reader(m["name"])(r) is None


def test_bounds_count_bytes_once():
    # graybox F = 64: winners 4 B a pixel and the bin tables; 15 ops a
    # pixel take less time than the bytes.
    pixels = 64 * 320 * 480
    want = (4 * pixels + 4 * 64 * 768 * 9 + 12 * 64) / bounds.HBM_BYTES_PER_S
    assert bounds.trace_bound_s(64, 320, 480, 768, 8) == pytest.approx(want)


def json_per_layer():
    import json
    return json.loads(spec.BENCHMARK.read_text())["per_layer"]
