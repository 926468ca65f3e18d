"""CPU tests of the benchmark's harness (run: ``python -m pytest perfbench/tests``).
Tests that need the card are marked ``chip`` and skip inside a fixture."""
import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True)
def fp32_policy():
    from repro_torch.numerics import set_fp32_policy
    set_fp32_policy()


SMALL = {
    "granite-3-2b.server-seq": (
        dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
             vocab_size=512),
        dict(phones=[{"cut": c} for c in (1, 1, 2, 2, 3, 3)], seqs=2, seq_len=16, pool=2)),
    "bert-base.cohort24": (
        dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
             vocab_size=4096, max_position=32),
        dict(batch=4, seq_len=16, train_examples=600)),
}


def small_cell(name: str, **mc_overrides):
    """The cell with its widths and sizes cut for the CPU (its topology,
    traffic shape, comparison and limits kept)."""
    from harness import cells
    cell = cells.load_cell(name)
    mc, tr = SMALL[name]
    cell.mc.update(copy.deepcopy(mc), **mc_overrides)
    cell.traffic.update(copy.deepcopy(tr))
    if name.startswith("bert"):
        cell.traffic["clients"] = cell.traffic["clients"][:6]
        cell.traffic["engine"] = dict(cell.traffic["engine"], cohort_chunk=6)
    return cell


CELLS = sorted(SMALL)
