"""The command's import graph loads neither JAX nor the JAX package:
a whole CPU run in a fresh process with ``sys.modules["jax"] = None``,
then every loaded module's top-level name, compared whole, checked.
``repro_torch`` begins with ``repro`` and must pass."""
import subprocess
import sys

from conftest import BENCH

SCRIPT = r'''
import sys, time
sys.modules["jax"] = None
sys.path[:0] = [{bench!r}, {src!r}]
sys.path.insert(0, {tests!r})
import runpy
runpy.run_path({run!r}, run_name="perfbench_run")   # the command's own module
from conftest import small_cell, CELLS
from harness import cells, runner
from repro_torch.numerics import set_fp32_policy
set_fp32_policy()
for name in CELLS:
    cell = small_cell(name)
    for m in cell.per_layer:
        cells.metric_reader(m["name"])
    runner.execute(cell, 11, 0.2, False, "cpu", time.time())
found = runner.forbidden_modules()
assert "repro_torch" in sys.modules
print("FORBIDDEN", found)
'''


def test_no_jax_and_no_jax_package():
    code = SCRIPT.format(bench=str(BENCH), src=str(BENCH.parent / "src"),
                         tests=str(BENCH / "tests"), run=str(BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from harness import runner
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in runner.forbidden_modules()
