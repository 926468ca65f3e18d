"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration's file is the one it names, the traffic mix is
``traffic/<traffic>.json``, the limits of its comparison are
``limits/<cell>.json``, the code that drives its kind of cell is
``kinds/<kind>.py`` (the traffic file names the kind), and each per-layer
metric is read by ``metrics/<metric>.py``.  A later cell or metric adds
files and entries; nothing here changes.  A cell that ``BENCHMARK.json``
does not hold is looked up in ``pending.json``, which has its format and
holds cells built but left out of the benchmark (the tests and
``calibrate.py`` run them).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PENDING = BENCH / "pending.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    mc: dict                 # the configuration as it is run
    traffic: dict
    limits: dict
    end_to_end: List[dict]   # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_file)
    if not any(w["name"] == name for w in bench["workloads"]) and PENDING.exists():
        pending = load_json(PENDING)
        if any(w["name"] == name for w in pending["workloads"]):
            bench = pending
    wl = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], wl["config"], "config")
    return Cell(name=name, chips=int(wl["chips"]),
                mc=load_json(ROOT / conf["file"])["model"],
                traffic=load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module that drives a kind of cell: ``Program`` and ``reference``."""
    return _module(BENCH / "kinds" / f"{name}.py", f"perfbench_kind_{name}")


def metric_reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py",
                   "perfbench_metric_" + name.replace(".", "_"))
