"""On the card: each cell's run, a short window, prints a correct result
line with its metrics."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench import spec

CELLS = [w["name"] for w in
         json.loads(spec.BENCHMARK.read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cuda_cell_runs_correct(cuda_device, cell, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", "424242", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=spec.ROOT.parent, timeout=400)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) == want
