"""The torch twin of the paper's example script runs end to end on the CPU
(``--tiny``, every scheme) and takes its cuts from the port's
``assign_cuts``, as the reference's script does."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "examples" / "train_emotion_sfl_torch.py"


def test_tiny_run_of_the_twin_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--tiny", "--rounds", "2",
                           "--agg-interval", "2", "--schemes", "ours,sl",
                           "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    cuts = re.search(r"cuts=\[([0-9, ]+)\]", out)
    assert cuts is not None, out
    for entry in ("ours", "sl"):
        assert re.search(rf"\[{entry}/ours\] round +2 t= *[0-9.]+s loss=[0-9.]+ "
                         rf"acc=[0-9.]+ f1=[0-9.]+", out), out
        assert re.search(rf"== {entry} \[analytic/sync\]: acc=[0-9.]+ f1=[0-9.]+ "
                         rf"sim_time=[0-9.]+s server_mem=[0-9.]+MB", out), out

    pytest.importorskip("jax")
    from repro.configs import REGISTRY, reduced
    from repro.core.partition import assign_cuts
    from repro.fed import PAPER_CLIENTS

    cfg = reduced(REGISTRY["bert-base"], n_layers=2, d_model=256).with_(
        vocab_size=4096, max_position=32, dtype="float32")
    want = assign_cuts(cfg, PAPER_CLIENTS, 4, 16, max_cut=cfg.n_layers - 1)
    assert [int(c) for c in cuts.group(1).split(",")] == want


def test_flags_outside_the_port_are_refused():
    """The twin takes exactly the reference example's flags and --device
    (every flag of the reference is ported), and argparse still refuses a
    flag it does not know rather than ignoring it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    reference = (ROOT / "examples" / "train_emotion_sfl.py").read_text()
    want = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', reference))
    proc = subprocess.run([sys.executable, str(SCRIPT), "--help"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    options = proc.stdout[proc.stdout.index("options:"):]
    listed = set(re.findall(r"^ {2}(?:-h, )?(--[a-z0-9-]+)", options, re.M))
    assert {"--snapshot-every", "--snapshot-dir", "--resume-from", "--kill-at"} <= want
    assert listed == want | {"--help", "--device"}
    proc = subprocess.run([sys.executable, str(SCRIPT), "--tiny", "--no-such-flag",
                           "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "unrecognized arguments" in proc.stderr


def test_tiny_async_run_of_the_twin_exits_zero(tmp_path):
    """The reference example's event-engine setting: buffered async commits
    with two local rounds in flight, traced."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--tiny", "--rounds", "2",
                           "--device", "cpu", "--engine", "event", "--agg-policy", "buffered",
                           "--max-inflight-rounds", "2", "--trace-out", str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert re.search(r"\[ours/ours/buffered\] commit +1 t= *[0-9.]+s loss=[0-9.na]+ "
                     r"acc=[0-9.]+ f1=[0-9.]+", out), out
    assert re.search(r"== ours \[event/buffered\]: acc=[0-9.]+ f1=[0-9.]+ "
                     r"sim_time=[0-9.]+s server_mem=[0-9.]+MB", out), out
    assert (tmp_path / "ours" / "trace.json").stat().st_size > 0


def test_tiny_controlled_run_of_the_twin_exits_zero():
    """The reference example's control-plane flags: a reactive controller on
    the event engine runs to its end and prints its decision log."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--tiny", "--rounds", "2",
                           "--device", "cpu", "--engine", "event", "--controller", "reactive"],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert re.search(r"== ours \[event/sync\]: acc=[0-9.]+ f1=[0-9.]+ "
                     r"sim_time=[0-9.]+s server_mem=[0-9.]+MB", out), out
    assert re.search(r"   control \(reactive\): [0-9]+ decisions, [0-9]+ applied; "
                     r"cuts \[[0-9, ]+\]", out), out


def test_tiny_killed_and_resumed_twin_matches(tmp_path):
    """The reference example's kill-and-resume flags on the async event
    setting: the run killed at 0.05 simulated s prints the preemption
    message, and the run resumed from its snapshots prints the
    uninterrupted run's records from the resume point on and its final
    line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    base = [sys.executable, str(SCRIPT), "--tiny", "--rounds", "3", "--device", "cpu",
            "--engine", "event", "--agg-policy", "buffered", "--max-inflight-rounds", "2"]
    snaps = str(tmp_path / "snaps")
    runs = {}
    for name, extra in (("whole", []),
                        ("killed", ["--snapshot-every", "0.02", "--snapshot-dir", snaps,
                                    "--kill-at", "0.05"]),
                        ("resumed", ["--resume-from", snaps])):
        proc = subprocess.run(base + extra, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, (name, proc.stderr[-2000:])
        runs[name] = [line for line in proc.stdout.splitlines() if line.strip()]
    assert re.search(r"== ours: PREEMPTED at t=[0-9.]+s \(snapshots in .*snaps; rerun "
                     r"with --resume-from to continue\)", "\n".join(runs["killed"]))
    final = [line for line in runs["whole"] if line.startswith("== ours [event/buffered]")]
    assert len(final) == 1 and runs["resumed"][-1] == final[0]
    resumed_records = [line for line in runs["resumed"] if line.startswith("[ours/")]
    whole_records = [line for line in runs["whole"] if line.startswith("[ours/")]
    assert resumed_records and whole_records[-len(resumed_records):] == resumed_records
