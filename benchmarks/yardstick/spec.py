"""Finding a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration and traffic mix under ``benchmarks/``, the metrics it
reports and each metric's reader.

A cell is its ``workloads`` entry in ``BENCHMARK.json``.  A
configuration is ``configs/<config>.json`` and names its file in
``BENCHMARK.json``; a traffic mix is ``traffic/<traffic>.json`` and names
the kind of loop that drives it (``yardstick/kinds/<kind>.py``); a
metric is ``metrics/<name>.py`` with a ``read(run)`` that returns its
value or None.  Adding any of them takes new files and new entries, no
edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent    # benchmarks/
ROOT = HERE.parent                               # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # BENCHMARK.json entries this cell reports
    per_layer: list
    here: Path = HERE  # the benchmark's folder: traffic/, metrics/


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, root: Path = ROOT,
         here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration and traffic mix loaded."""
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                here=here)


def kind(traffic: dict):
    """The module that drives a traffic mix's ``kind``."""
    return importlib.import_module(f"yardstick.kinds.{traffic['kind']}")


def reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, run, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of the entries whose reader finds
    something in ``run``."""
    out = {}
    for m in entries:
        value = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


__all__ = ["Cell", "HERE", "ROOT", "cell", "kind", "load_benchmark",
           "read_metrics", "reader"]
