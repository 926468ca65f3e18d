"""Kill and resume in the port, bit for bit, on the CPU.

Each case runs a Simulator uninterrupted, then the same configuration with
periodic snapshots (``snapshot_every`` / ``snapshot_dir``) and a preemption
(``preempt_at``), then resumes the snapshot directory in a FRESH Simulator
(``resume_from``).  The resumed run must equal the uninterrupted one
exactly: the clock's ``state_dict`` JSON, ``history``, ``loss_events``,
``discarded_updates``, the obs outputs where obs is on, and ``torch.equal``
on every leaf of the final ``_global_full`` and ``_global_head``.

The cases are the twins of the reference's
``tests/test_async_engine.py::test_simulator_kill_resume_bit_for_bit`` (its
three ``_SIM_CKPT_COMBOS``), ``tests/test_obs_parity.py``'s trace
continuity and obs-off resume, ``tests/test_checkpoint_manager.py::
test_federated_resume_identical`` (the analytic engine's whole-run
boundary) and ``test_resume_rejects_mismatched_config``; and two of the
port's own: int8 links with error feedback on the fused ragged cohort step
with two rounds in flight (the resumed snapshot holds in-flight pulls and
error-feedback residuals, and serves run between it and the kill), and a
reactive control plane whose snapshot holds a migrated cut.  Every run
starts from the port's own seeded initial state; the frozen weights of the
resumed Simulator come from the same seed.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import net
from repro_torch.checkpointing import CheckpointManager, load_snapshot, save, unpack_json
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import make_emotion_dataset
from repro_torch.fed import (PAPER_CLIENTS, AggConfig, ControlConfig, EngineConfig,
                             FedRunConfig, NetConfig, ObsConfig, Simulator,
                             validate_run_config)
from repro_torch.numerics import set_fp32_policy
from repro_torch.tree import tree_leaves

set_fp32_policy()

CUTS = [1, 1, 1, 1]
RUN_KW = dict(rounds=3, batch_size=4, seq_len=16, lr=3e-3, eval_every=100)


@pytest.fixture(scope="module")
def data():
    return (make_emotion_dataset(400, seq_len=16, vocab_size=4096, seed=0),
            make_emotion_dataset(100, seq_len=16, vocab_size=4096, seed=1))


def _cfg(n_layers=2, d_model=256):
    return reduced(REGISTRY["bert-base"], n_layers=n_layers,
                   d_model=d_model).with_(vocab_size=4096, max_position=32)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _assert_identical_runs(ref, got):
    """Timeline, run log, obs outputs and final global model, bit for bit."""
    assert got._clock.now == ref._clock.now
    assert json.dumps(got._clock.state_dict(), sort_keys=True) == \
        json.dumps(ref._clock.state_dict(), sort_keys=True)
    # NaN-tolerant exact equality (a commit with no serve since the last)
    np.testing.assert_equal([dataclasses.astuple(r) for r in got.history],
                            [dataclasses.astuple(r) for r in ref.history])
    assert got.loss_events == ref.loss_events
    assert got.discarded_updates == ref.discarded_updates
    assert _equal_trees(got._global_full, ref._global_full)
    assert _equal_trees(got._global_head, ref._global_head)
    assert got.cuts == ref.cuts
    assert [dataclasses.asdict(e) for e in got.control_events] == \
        [dataclasses.asdict(e) for e in ref.control_events]
    if ref.obs is not None and got.obs is not None:
        assert json.dumps(got.obs.tracer.to_chrome(), sort_keys=True) == \
            json.dumps(ref.obs.tracer.to_chrome(), sort_keys=True)
        assert got.obs.metrics.to_json() == ref.obs.metrics.to_json()
        assert got.obs.ledger.report() == ref.obs.ledger.report()


def _kill_and_resume(mk, snap_dir, every_frac, kill_frac):
    """The uninterrupted run, the snapshotting run killed at
    ``kill_frac`` of its span, the snapshot the resume reads, and the
    resumed run."""
    ref = mk()
    ref.run_training()
    span = ref._clock.now
    killed = mk(snapshot_every=span * every_frac, snapshot_dir=snap_dir,
                preempt_at=span * kill_frac)
    killed.run_training()
    assert killed.clock_result.preempted
    assert killed._clock.now < ref._clock.now
    # the snapshotting run followed the uninterrupted timeline up to the
    # kill, and a preempted run is not evaluated as finished
    assert killed.loss_events == ref.loss_events[:len(killed.loss_events)]
    np.testing.assert_equal([dataclasses.astuple(r) for r in killed.history],
                            [dataclasses.astuple(r) for r in ref.history[:len(killed.history)]])
    snap = load_snapshot(snap_dir, device="cpu")
    resumed = mk(resume_from=snap_dir)
    resumed.run_training()
    assert not resumed.clock_result.preempted
    _assert_identical_runs(ref, resumed)
    return ref, killed, snap


def _groups(scheduler="fifo", policy="buffered", buffer_k=None, max_inflight=1,
            staleness_alpha=None, link_model="constant", shared=False, capacity=None,
            transport="nominal", controller="static", hysteresis=None):
    return dict(engine=EngineConfig(mode="event", scheduler=scheduler),
                agg=AggConfig(policy=policy, interval=1, buffer_k=buffer_k,
                              max_inflight=max_inflight, staleness_alpha=staleness_alpha,
                              transport=transport),
                net=NetConfig(link_model=link_model, shared=shared, capacity_mbps=capacity),
                control=ControlConfig(policy=controller, hysteresis=hysteresis))


# the reference's _SIM_CKPT_COMBOS, in the grouped sub-configs
COMBOS = {
    "buffered-gilbert": _groups(policy="buffered", buffer_k=2, max_inflight=2,
                                link_model="gilbert"),
    "sync": _groups(scheduler="ours", policy="sync"),
    "staleness-cell-plane-reactive": _groups(
        policy="staleness", max_inflight=2, staleness_alpha=0.5, link_model="gilbert",
        shared=True, capacity=150.0, transport="plane", controller="reactive",
        hysteresis=0.2),
}


@pytest.mark.parametrize("name", list(COMBOS))
def test_simulator_kill_resume_bit_for_bit(data, tmp_path, name):
    def mk(**extra):
        return Simulator(_cfg(), PAPER_CLIENTS[:4], CUTS, *data,
                         FedRunConfig(**RUN_KW, **COMBOS[name], **extra), device="cpu")

    _kill_and_resume(mk, str(tmp_path / "snaps"), 1 / 7, 0.6)


def test_resumed_run_continues_the_snapshot_series(data, tmp_path):
    """A resumed run that snapshots into the same directory continues the
    original cadence past its resume point (it does not re-snapshot it):
    its retained snapshots are those of an uninterrupted snapshotting run,
    step for step and instant for instant."""
    def mk(**extra):
        return Simulator(_cfg(), PAPER_CLIENTS[:4], CUTS, *data,
                         FedRunConfig(**RUN_KW, **COMBOS["buffered-gilbert"], **extra),
                         device="cpu")

    ref = mk()
    ref.run_training()
    every = ref._clock.now / 7
    dirs = {name: str(tmp_path / name) for name in ("whole", "killed")}
    whole = mk(snapshot_every=every, snapshot_dir=dirs["whole"])
    whole.run_training()
    _assert_identical_runs(ref, whole)          # snapshots are pure reads
    mk(snapshot_every=every, snapshot_dir=dirs["killed"],
       preempt_at=ref._clock.now * 0.6).run_training()
    resumed = mk(snapshot_every=every, snapshot_dir=dirs["killed"],
                 resume_from=dirs["killed"])
    resumed.run_training()
    _assert_identical_runs(ref, resumed)
    series = {}
    for name, path in dirs.items():
        mgr = CheckpointManager(path)
        series[name] = [(step, unpack_json(mgr.restore(step, device="cpu")["des"])["clock"]["now"])
                        for step in mgr.all_steps()]
    assert series["killed"] == series["whole"] and len(series["whole"]) == 3


def test_kill_resume_int8_fused_cohort_in_flight(data, tmp_path):
    """Buffered commits of two with two rounds in flight, ragged chunks of
    two through the fused kernels, int8 links with error feedback: the
    snapshot holds in-flight pulls and every client's residual, and the
    killed run served past it (the resumed run replays those serves)."""
    def mk(**extra):
        run = FedRunConfig(**RUN_KW,
                           engine=EngineConfig(mode="event", scheduler="fifo",
                                               fused_lora=True, cohort_chunk=2,
                                               cohort_impl="ragged"),
                           agg=AggConfig(policy="buffered", interval=1, buffer_k=2,
                                         max_inflight=2),
                           net=NetConfig(quantize=True), **extra)
        return Simulator(_cfg(), PAPER_CLIENTS[:4], CUTS, *data, run, device="cpu")

    _, killed, snap = _kill_and_resume(mk, str(tmp_path / "snaps"), 0.45, 0.6)
    assert snap["round_pull"] and sorted(snap["ef_residual"]) == ["0", "1", "2", "3"]
    for pull in snap["round_pull"].values():
        assert pull["lora"] and int(pull["ver"]) >= 0
    served_at_snapshot = len(unpack_json(snap["des"])["clock"]["serves"])
    assert len(killed.clock_result.serves) > served_at_snapshot


def test_kill_resume_after_a_migration(data, tmp_path):
    """A reactive controller moves client 0's cut on a fading link (the
    setting of tests/test_torch_control.py at 3 layers, devices at a tenth
    of the paper's rates); the snapshot the resume reads holds the migrated
    cut, which the fresh Simulator restores in place (re-sliced prefix,
    steps, priorities) before the clock continues."""
    devs = [dataclasses.replace(d, tflops=d.tflops / 10.0) for d in PAPER_CLIENTS[:4]]
    cuts = [2] * 4

    def mk(**extra):
        links = [net.TraceLink([0.0, 0.001], [100.0, 4.0])] + [net.ConstantLink(100.0)] * 3
        run = FedRunConfig(**{**RUN_KW, "lr": 1e-3}, **_groups(
            link_model="custom", controller="reactive", hysteresis=0.25), **extra)
        return Simulator(_cfg(3, 128), devs, cuts, *data, run, links=links, device="cpu")

    ref, _, snap = _kill_and_resume(mk, str(tmp_path / "snaps"), 0.32, 0.5)
    assert [int(c) for c in snap["cuts"]] != cuts
    assert [int(c) for c in snap["cuts"]] == ref.cuts
    assert any(d.applied and d.cut_changes for d in ref.control_events)
    resumed = mk(resume_from=str(tmp_path / "snaps"))
    resumed.resume(str(tmp_path / "snaps"))
    assert resumed._control.cuts is resumed.cuts and resumed.cuts == ref.cuts
    for u, cut in enumerate(resumed.cuts):
        assert tree_leaves(resumed.client_params[u]["layers"])[0].shape[0] == cut
        assert cut in resumed._cli_steps and cut in resumed._srv_steps


def test_analytic_resume_identical(data, tmp_path):
    """The analytic engine at a round boundary (twin of the reference's
    test_federated_resume_identical): save after round 2, load into a FRESH
    Simulator, run rounds 3-4; equal to the uninterrupted run bit for bit."""
    cfg = _cfg()
    run = FedRunConfig(rounds=4, batch_size=16, seq_len=16, lr=3e-3, eval_every=99,
                       agg=AggConfig(interval=10))
    train = make_emotion_dataset(800, seq_len=16, vocab_size=4096, seed=0)

    def fresh():
        return Simulator(cfg, PAPER_CLIENTS, [1] * 6, train, data[1], run, device="cpu")

    sim_a = fresh()
    for r in range(4):
        sim_a.run_round(r)
    sim_b = fresh()
    for r in range(2):
        sim_b.run_round(r)
    mgr = CheckpointManager(str(tmp_path / "fed"))
    mgr.save(2, sim_b.state_dict())

    sim_c = fresh()
    start = sim_c.load_state_dict(mgr.restore(device="cpu"))
    assert start == 2
    assert [r.mean_loss for r in sim_c.history] == [r.mean_loss for r in sim_a.history[:2]]
    for r in range(start, 4):
        sim_c.run_round(r)
    np.testing.assert_equal([dataclasses.astuple(r) for r in sim_c.history],
                            [dataclasses.astuple(r) for r in sim_a.history])
    for u in range(6):
        assert _equal_trees(sim_c.client_lora[u], sim_a.client_lora[u])
        assert _equal_trees(sim_c.server_lora[u], sim_a.server_lora[u])
        assert _equal_trees(sim_c.client_opt[u], sim_a.client_opt[u])
    assert sim_c.sim_clock == sim_a.sim_clock


def _traced(**extra):
    return FedRunConfig(**RUN_KW, **_groups(
        policy="staleness", max_inflight=2, staleness_alpha=0.5, shared=True,
        capacity=150.0, transport="plane"),
        obs=ObsConfig(trace=True, metrics=True, memory_ledger=True), **extra)


def test_kill_resume_trace_continuity(data, tmp_path):
    """Twin of tests/test_obs_parity.py::test_kill_resume_trace_continuity:
    the resumed run's trace, metrics and ledger equal the uninterrupted
    run's (open shared-cell marks restored across the boundary)."""
    cfg = _cfg(3, 128)

    def mk(**extra):
        return Simulator(cfg, PAPER_CLIENTS[:4], CUTS, *data, _traced(**extra), device="cpu")

    ref, _, _ = _kill_and_resume(mk, str(tmp_path / "snaps"), 1 / 7, 0.6)
    assert len(ref.obs.tracer) > 0


def test_resume_into_obs_off_run_is_allowed(data, tmp_path):
    """obs is popped from the fingerprint: a snapshot written with tracing
    on resumes into an obs-off run on the same timeline."""
    cfg = _cfg(3, 128)

    def mk(obs, **extra):
        run = FedRunConfig(**{**RUN_KW, "rounds": 2}, **_groups(
            policy="buffered", buffer_k=2, max_inflight=2), obs=obs, **extra)
        return Simulator(cfg, PAPER_CLIENTS[:4], CUTS, *data, run, device="cpu")

    ref = mk(ObsConfig())
    ref.run_training()
    span = ref._clock.now
    snap_dir = str(tmp_path / "snaps")
    killed = mk(ObsConfig(trace=True, metrics=True), snapshot_every=span / 5,
                snapshot_dir=snap_dir, preempt_at=span * 0.5)
    killed.run_training()
    assert killed.clock_result.preempted
    resumed = mk(ObsConfig(), resume_from=snap_dir)
    resumed.run_training()
    assert resumed.obs is None
    _assert_identical_runs(ref, resumed)


def test_resume_rejects_mismatched_config(data, tmp_path):
    """A snapshot resumes only against an identically configured run."""
    def mk(**extra):
        run = FedRunConfig(**{**RUN_KW, "rounds": 2}, **_groups(policy="buffered", buffer_k=2),
                           **extra)
        return Simulator(_cfg(), PAPER_CLIENTS[:4], CUTS, *data, run, device="cpu")

    sim = mk()
    sim.run_training()
    path = str(tmp_path / "snap.ckpt")
    save(path, sim.state_dict())
    with pytest.raises(ValueError, match="fingerprint"):
        mk(seed=1).resume(path)
    # the identical config resumes fine (whole-run boundary: a no-op run)
    fresh = mk(resume_from=path)
    fresh.run_training()
    _assert_identical_runs(sim, fresh)


@pytest.mark.parametrize("knob", [dict(snapshot_every=1.0, snapshot_dir="snaps"),
                                  dict(resume_from="snaps"), dict(preempt_at=0.5)])
def test_snapshot_knobs_need_the_event_engine(knob):
    """The closed form has no in-flight state: the reference's check
    refuses the knobs under the analytic engine, and the port keeps it."""
    with pytest.raises(ValueError, match="event-clock notions"):
        validate_run_config(FedRunConfig(**RUN_KW, **knob), 4)


def test_chip_smoke_resume_prediction_is_pinned():
    """``chip_smoke.py --predict-resume`` replays the [resume] phase's three
    kills and resumes on the CPU at bert-base's full-width timing.  Its last
    output, the ``PREDICTED_RESUME`` literal, is the text the script holds
    the card's runs to; and the snapshots it reads are the ones the phase
    needs: the event run's holds in-flight pulls and a residual and serves
    follow it before the kill, the controlled runs' hold a migrated cut."""
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script), "--predict-resume"],
                          env=dict(os.environ, OMP_NUM_THREADS="4"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    printed = out[out.index("PREDICTED_RESUME = "):].rstrip("\n")
    source = script.read_text()
    start = source.index("PREDICTED_RESUME = {")
    assert source[start:source.index("\n\n\n", start)] == printed
    pred = {line.split(" ", 1)[0][len("[predict:resume:"):-1]: json.loads(line.split(" ", 1)[1])
            for line in out.splitlines() if line.startswith("[predict:resume:")}
    event = pred["event:buffered"]
    assert event["round_pulls"] > 0 and event["ef_residuals"] > 0
    assert event["replayed_serves"] >= 1 and event["resume_launches"]["grouped_lora_chunk"] > 0
    for key in ("control:sync", "control:buffered"):
        assert pred[key]["cuts"] != [1, 1, 2, 2, 3, 3]
    for run in pred.values():
        assert run["snapshot_time"] == run["snapshot_times"][-1] <= run["kill_time"]
