"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the sizes,
with its scene generator ``configs/<config>.py`` beside it),
``traffic/<traffic>.json`` (the mix, run by ``entries/<entry>.py``) and,
for each per-layer metric, ``metrics/<metric>.py``.  A later cell or
metric is new files and entries, never an edit of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # configs/<name>.json
    traffic_name: str
    traffic: dict          # traffic/<name>.json
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]   # ... and with --trace 1

    def scene(self) -> dict:
        """The scene arrays of the configuration's generator."""
        return load_module(ROOT / "configs" / f"{self.config_name}.py"
                           ).scene(self.config)

    def entry(self):
        return load_module(ROOT / "entries" / f"{self.traffic['entry']}.py")


def load_module(path: pathlib.Path):
    """Import a file of the benchmark by path (metric files have dots in
    their names)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    name = "port_bench._file_." + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, benchmark: pathlib.Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``benchmark``; raises ``KeyError`` for a name
    it does not hold."""
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    return make_cell(name, w["config"], w["traffic"], w["chips"], bench)


def make_cell(name: str, config: str, traffic: str, chips: int,
              bench: dict) -> Cell:
    """A cell of configuration ``config`` under mix ``traffic`` with the
    metrics of ``bench`` that apply to ``name`` (also one that ``bench``
    does not list, for tests)."""
    config_data = json.loads((ROOT / "configs" / f"{config}.json")
                             .read_text())
    mix = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if m["moves"] in reported and applies(m, name)]
    return Cell(name, chips, config, config_data, traffic, mix, e2e, layers)


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    return load_module(ROOT / "metrics" / f"{name}.py").read
