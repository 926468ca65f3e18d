"""BENCHMARK.json against its format's shapes and characters, and every
cell's, configuration's, traffic mix's and metric's files found by name."""
import json
import re

import pytest

from conftest import BENCH
from harness import cells

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
PENDING = json.loads(cells.PENDING.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|expansion|expert)")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    named = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"]) for w in named)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_entry_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_reports_what_the_format_asks():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cell_names = {w["name"] for w in SPEC["workloads"]}
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cell_names)) <= cell_names
    for cell in cell_names:
        own = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in own and len(own) >= 2
        layers = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers
        for m in layers:        # each per-layer metric's end-to-end metric is the cell's
            assert m["moves"] in own


def test_metrics_of_one_layer_name_it_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"] + PENDING["workloads"]])
def test_discovery_by_name(name):
    cell = cells.load_cell(name)
    kind = cells.kind(cell.traffic["kind"])
    assert hasattr(kind, "Program") and hasattr(kind, "reference")
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
    for number in ("loss_gap", "grad_gap", "change_gap"):
        assert cell.limits[number]["limit"] > 0
    assert cell.mc["name"] == name.split(".")[0]


def test_pending_cells_are_out_of_the_benchmark_and_in_its_format():
    assert not {w["name"] for w in PENDING["workloads"]} & {w["name"] for w in SPEC["workloads"]}
    by_name = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for m in PENDING["end_to_end"] + PENDING["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        if m["name"] in by_name:        # a metric the benchmark has is the same metric
            assert {k: v for k, v in by_name[m["name"]].items()
                    if k not in ("bound", "workloads")} == m
    for w in PENDING["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])


def test_a_new_cell_is_files_and_entries(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    w = dict(spec["workloads"][0], name="granite-3-2b.extra")
    spec["workloads"].append(w)
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    with pytest.raises(FileNotFoundError):    # its limits file is its own
        cells.load_cell("granite-3-2b.extra", bench)
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell", bench)
