"""The run's contract: the result line's keys, no CPU fallback, and no
JAX module loaded by the benchmark or the reference."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from port_bench import run, spec
from port_bench.tests.cells import CPU, run_small, small_cell

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "pixel_art_raytracer_tpu"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    cell = small_cell("graybox.live")
    record, setup_s, peak, compared = run_small("graybox.live",
                                                trace=bool(trace))
    out = run.result(cell, record, setup_s, peak, compared, CPU, trace)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert out["correct"] is True
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(out)


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "graybox.orbit64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT.parent, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pixel_art_raytracer_tpu_torch_x",
                        sys.modules["json"])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pixel_art_raytracer_tpu.ops",
                        sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    assert run.forbidden_modules() == ["jaxlib",
                                       "pixel_art_raytracer_tpu.ops"]


def imports(path) -> set[str]:
    """Top-level names of the modules a file imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in spec.ROOT.rglob("*.py"):
        assert not imports(path) & FORBIDDEN_TOP, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.ROOT / "reference").glob("*.py"):
        assert imports(path) <= {"__future__", "dataclasses", "typing",
                                 "numpy", "torch"}, path


def test_a_run_loads_no_jax_module():
    code = ("import sys, time, torch; from port_bench import harness, run;"
            "from port_bench.tests.cells import small_cell, CPU;"
            "harness.run(small_cell('config5.still'), 3, 0.2, False, CPU,"
            " time.perf_counter());"
            "print(run.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=spec.ROOT.parent, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
