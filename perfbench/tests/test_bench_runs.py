"""A whole run of each cell on the CPU at a cut size, the look for a card
skipped: sound, it reads correct; with a fault planted in the timed path,
or with the control (the reference one precision below the
configuration's) in the program's place, it does not."""
import time

import pytest

import faults
from conftest import CELLS, small_cell
from harness import cells, compare, runner

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def _run(cell, trace=False):
    return runner.execute(cell, 2**31 + 977, 0.5, trace, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(small_cell(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = cells.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_no_device_metric_on_the_cpu(name):
    res = _run(small_cell(name), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}
    assert res["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    faults.plant(monkeypatch, name, fault)
    res = _run(small_cell(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    kind = cells.kind(cell.traffic["kind"])
    seed = 2**31 + 5
    ref = kind.reference(cell.mc, cell.traffic, seed, "cpu")
    control = kind.reference(cell.mc, cell.traffic, seed, "cpu", CONTROL[cell.mc["dtype"]])
    checks = compare.check(compare.numbers(control, ref), cell.limits)
    assert not compare.all_ok(checks), checks


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_own_size(name, card):
    """The control against the reference at the cell's full size, on the
    card (``perfbench/calibrate.py`` reads it over three seeds or more)."""
    cell = cells.load_cell(name)
    kind = cells.kind(cell.traffic["kind"])
    seed = 2**31 + 17
    ref = kind.reference(cell.mc, cell.traffic, seed, "cuda")
    control = kind.reference(cell.mc, cell.traffic, seed, "cuda", CONTROL[cell.mc["dtype"]])
    checks = compare.check(compare.numbers(control, ref), cell.limits)
    assert not compare.all_ok(checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_calibration_reads_the_program_the_control_and_the_faults(name, monkeypatch, capsys):
    import json
    import runpy
    small = small_cell(name)
    monkeypatch.setattr(cells, "load_cell", lambda n: small)
    calibrate = runpy.run_path(str(cells.BENCH / "calibrate.py"))
    assert calibrate["main"](["--workload", name, "--seeds", "1", "--control-seeds", "1",
                              "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kind"] for r in rows] == ["program", f"control_{CONTROL[small.mc['dtype']]}",
                                         "fault_half_batch", "fault_altered_answer"]
    assert all(rows[0][k] <= lim["limit"] for k, lim in small.limits.items() if k in rows[0])
