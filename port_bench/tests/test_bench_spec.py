"""BENCHMARK.json: every name resolves to its files, and the file keeps
the benchmark's contract on names, units, bounds and lengths."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import spec

BENCH = json.loads(spec.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(spec.BENCHMARK.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert (spec.ROOT / "configs" / f"{c.config_name}.py").exists()
    assert (spec.ROOT / "entries" / f"{c.traffic['entry']}.py").exists()
    assert c.scene  # the generator and the entry load by name
    assert hasattr(c.entry(), "Entry") and hasattr(c.entry(), "expected")
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_config_files_list_every_reduced_key():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT.parent / c["file"]).read_text())
        assert set(c["reduced"]) == set(data["reduced"])
        assert all(k in data for k in c["reduced"])
        assert data["source"] and data["assumed"] is not None


def test_names_units_and_lengths():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              CELLS))
