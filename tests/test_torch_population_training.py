"""Real-math training on sampled cohorts in the port: the cohort-resident
``PopulationTrainer`` driven by the ``PopulationClock``.

Port only, bit for bit: the trainer against the port's own Simulator under
the same seeds on the reference's representative rows (Pareto cohorts on
the vmap step with flat commits, uniform cohorts on the ragged step with
two-tier commits, buffered async commits) — every loss event, history row,
global adapter leaf and the makespan.  Against the JAX package: the port's
trainer, started from the reference trainer's initial state
(``bridge.load_reference_trainer_state``), at reduced(bert-base, 4 layers,
d 128), vocab 4096, seq 16, batch 4: loss events' uids, rounds and times
equal, losses within LOSS_RTOL, the global adapters within ADAPTER_ATOL.
Also: the anchored mode at or above the threshold trains on cohort-resident
slots only; ``run_federated_training`` routes on the threshold;
``validate_population_training`` refuses what the reference refuses; the
two-tier aggregations and ``CohortAdapterStore`` against the reference's.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import math

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import REGISTRY, reduced
from repro_torch.core import aggregation as t_agg
from repro_torch.core import lora as t_lora
from repro_torch.core.splitfl import CohortAdapterStore
from repro_torch.data import make_emotion_dataset
from repro_torch import fed as T
from repro_torch.fed.config import validate_population_training
from repro_torch.fed.population_training import PopulationTrainer, train_population
from repro_torch.fed.simulator import run_federated_training
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

set_fp32_policy()

LR = 1e-3
RUN_KW = dict(batch_size=4, seq_len=16, lr=LR)
LOSS_RTOL = 1e-4
# adapters after two AdamW steps and the commits (ROADMAP Queue C: a
# first step moves a near-zero-gradient element by about lr either way)
ADAPTER_ATOL = 2 * LR * 2
SPEC = dict(n=6, seed=3, link_model="constant")


@pytest.fixture(scope="module")
def data():
    return (make_emotion_dataset(600, seq_len=16, vocab_size=4096, seed=0),
            make_emotion_dataset(120, seq_len=16, vocab_size=4096, seed=1))


def _cfg():
    return reduced(REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)


def _sync_run(M, sampling, impl, cells):
    return M.FedRunConfig(
        **RUN_KW, rounds=2, eval_every=2, net=M.NetConfig(link_model="custom"),
        engine=M.EngineConfig(mode="event", scheduler="ours", slots=2, cohort_chunk=2,
                              cohort_impl=impl),
        agg=M.AggConfig(policy="sync", interval=1),
        fleet=M.FleetConfig(sampling=sampling, rate=0.6, edge_cells=cells))


def _async_run(M, impl):
    return M.FedRunConfig(
        **RUN_KW, rounds=2, eval_every=2, net=M.NetConfig(link_model="custom"),
        engine=M.EngineConfig(mode="event", scheduler="ours", slots=2, cohort_chunk=2,
                              cohort_impl=impl),
        agg=M.AggConfig(policy="buffered", interval=1, buffer_k=3, max_inflight=2))


ROWS = {"pareto-vmap-flat": lambda M: _sync_run(M, "pareto", "vmap", 1),
        "uniform-ragged-hier": lambda M: _sync_run(M, "uniform", "ragged", 2),
        "async-buffered": lambda M: _async_run(M, "vmap")}


def _hist(sim_like):
    """History rows with nan-normalized mean_loss (an async commit on an
    empty wave records nan, and nan != nan)."""
    return [(r.round, r.sim_time_s, None if math.isnan(r.mean_loss) else r.mean_loss,
             r.accuracy, r.f1) for r in sim_like.history]


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("row", list(ROWS))
def test_trainer_matches_simulator_bit_for_bit(data, row):
    """The trainer's cohort-resident slots, fresh views of the global for
    untouched clients and its commits reproduce the eager Simulator."""
    train, test = data
    spec = T.FleetSpec(**SPEC)
    sim = T.Simulator(_cfg(), fleet=spec, train=train, test=test, run=ROWS[row](T),
                      device="cpu")
    sim.run_training()
    tr = train_population(_cfg(), spec.population(), ROWS[row](T), train, test,
                          device="cpu")
    assert tr.exact and tr.loss_events
    assert tr.loss_events == sim.loss_events
    assert _hist(tr) == _hist(sim)
    assert tr.discarded_updates == sim.discarded_updates
    assert _equal_trees(tr.store.global_full, sim._global_full)
    assert torch.equal(tr.store.global_head, sim._global_head)
    assert tr.clock_result.makespan == sim.sim_clock
    assert all(math.isfinite(e[3]) for e in tr.loss_events)


def _leaf_max_diff(got, want):
    if isinstance(got, dict):
        return max(_leaf_max_diff(got[k], want[k]) for k in got)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_trainer_matches_reference_trainer():
    """Sync Pareto cohorts on the vmap step, two edge cells: the port's
    trainer from the reference trainer's initial state against the
    reference trainer."""
    jax = pytest.importorskip("jax")
    from repro import fed as J
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make
    from repro.fed.population import PopulationClock as JClock
    from repro.fed.population_training import PopulationTrainer as JTrainer

    def mk(M):
        return _sync_run(M, "pareto", "vmap", 2)

    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)
    jfleet = J.FleetSpec(**SPEC).population()
    jt = JTrainer(jcfg, jfleet, mk(J), j_make(600, seq_len=16, vocab_size=4096, seed=0),
                  j_make(120, seq_len=16, vocab_size=4096, seed=1))
    state = {"params": jax.tree.map(np.asarray, jt.params),
             "global_full": jax.tree.map(np.asarray, jt.store.global_full),
             "global_head": np.asarray(jt.store.global_head)}
    jt.clock_result = JClock(jcfg, jfleet, mk(J), trainer=jt).run()

    tfleet = T.FleetSpec(**SPEC).population()
    tt = PopulationTrainer(_cfg(), tfleet, mk(T),
                           make_emotion_dataset(600, seq_len=16, vocab_size=4096, seed=0),
                           make_emotion_dataset(120, seq_len=16, vocab_size=4096, seed=1),
                           device="cpu")
    bridge.load_reference_trainer_state(tt, state)
    tt.clock_result = T.PopulationClock(_cfg(), tfleet, mk(T), trainer=tt).run()

    assert tt.data_sizes == jt.data_sizes
    assert [e[:3] for e in tt.loss_events] == [e[:3] for e in jt.loss_events]
    for (*_, tl), (*_, jl) in zip(tt.loss_events, jt.loss_events):
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert [(r.round, r.sim_time_s) for r in tt.history] == \
        [(r.round, r.sim_time_s) for r in jt.history]
    assert tt.clock_result.makespan == jt.clock_result.makespan
    assert tt.clock_result.cohort_sizes == jt.clock_result.cohort_sizes
    assert tt.edge_masses == jt.edge_masses
    assert _leaf_max_diff(tt.store.global_full, jt.store.global_full) <= ADAPTER_ATOL
    assert _leaf_max_diff(tt.store.global_head, jt.store.global_head) <= ADAPTER_ATOL
    assert tt.history[-1].accuracy == jt.history[-1].accuracy
    with pytest.raises(ValueError, match="before any slot"):
        bridge.load_reference_trainer_state(tt, state)


def test_anchored_mode_trains_on_cohort_slots(data):
    """At/above the threshold only sampled clients hold state: the
    anchored merge trains (finite loss falling, adapters move) and the
    resident slots never outnumber the largest cohort."""
    train, test = data
    spec = T.FleetSpec(n=12, seed=3, link_model="constant")
    run = T.FedRunConfig(
        batch_size=8, seq_len=16, lr=3e-3, rounds=6, eval_every=100,
        engine=T.EngineConfig(mode="event", scheduler="ours", slots=2, cohort_chunk=2),
        agg=T.AggConfig(policy="sync", interval=1),
        fleet=T.FleetConfig(sampling="pareto", rate=0.3, population_threshold=1,
                            edge_cells=2, cell_assignment="kmeans"))
    tr = train_population(_cfg(), spec.population(), run, train, test, device="cpu")
    assert not tr.exact
    assert set(tr.clock_result.modes) == {"vectorized"}
    losses = [ls for *_, ls in tr.loss_events]
    assert losses and all(math.isfinite(x) for x in losses)
    k = max(1, len(losses) // 3)
    assert np.mean(losses[-k:]) < np.mean(losses[:k])
    base = tr.model.init_lora(torch.Generator().manual_seed(run.seed + 1))
    assert not _equal_trees(tr.store.global_full, base)
    assert len(tr.store.touched()) <= max(tr.clock_result.cohort_sizes)
    assert len(tr.edge_summaries) == 2
    assert 0.0 <= tr.history[-1].accuracy <= 1.0


def test_run_federated_training_routes_on_threshold(data):
    train, test = data
    spec = T.FleetSpec(**SPEC)
    sim = run_federated_training(_cfg(), spec, ROWS["pareto-vmap-flat"](T), train, test,
                                 device="cpu")
    assert isinstance(sim, T.Simulator) and sim.loss_events
    big = T.FedRunConfig(**RUN_KW, rounds=1, eval_every=100,
                         engine=T.EngineConfig(mode="event", scheduler="ours", slots=2,
                                               cohort_chunk=2),
                         agg=T.AggConfig(policy="sync", interval=1),
                         fleet=T.FleetConfig(sampling="uniform", rate=0.5,
                                             population_threshold=2))
    tr = run_federated_training(_cfg(), spec, big, train, test, device="cpu")
    assert isinstance(tr, PopulationTrainer) and not tr.exact and tr.loss_events


def _bad_runs(M):
    ev = dict(rounds=1, engine=M.EngineConfig(mode="event", scheduler="ours"))
    return {"ok": M.FedRunConfig(**ev),
            "sfl": M.FedRunConfig(rounds=1, scheme="sfl",
                                  engine=M.EngineConfig(mode="event", scheduler="ours")),
            "analytic": M.FedRunConfig(rounds=1, engine=M.EngineConfig(mode="analytic")),
            "stragglers": M.FedRunConfig(**ev, fleet=M.FleetConfig(straggler_prob=0.3)),
            "int8": M.FedRunConfig(**ev, net=M.NetConfig(quantize="int8")),
            "plane": M.FedRunConfig(**ev, agg=M.AggConfig(transport="plane")),
            "control": M.FedRunConfig(**ev, control=M.ControlConfig(policy="reactive")),
            "snapshots": M.FedRunConfig(**ev, snapshot_every=0.5, snapshot_dir="x")}


@pytest.mark.parametrize("name", list(_bad_runs(T)))
def test_validation_matches_reference(name):
    """Knobs whose per-object streams the trainer cannot replicate are
    refused up front, with the reference's message."""
    pytest.importorskip("jax")
    from repro.fed import config as j_config

    outcomes = []
    for mod, M in ((j_config, j_config), (None, T)):
        validate = (mod.validate_population_training if mod is not None
                    else validate_population_training)
        try:
            validate(_bad_runs(M)[name], 8)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (name == "ok")


def _trees(seed, n):
    rs = np.random.default_rng(seed)
    return [{"layers": {"attn": {w: {"a": rs.standard_normal((3, 4, 16)).astype(np.float32),
                                     "b": rs.standard_normal((3, 16, 4)).astype(np.float32)}
                                 for w in ("wq", "wv")}}}
            for _ in range(n)]


def _assert_equal_tree(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _assert_equal_tree(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal_tree(a, b)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


HIER_CASES = {
    "two-cells": ([[0, 2, 4], [1, 3]], None),
    "empty-cell": ([[0, 1, 2, 3, 4], []], None),
    "shared-member": ([[0, 1, 2], [2, 3, 4]], "must not share"),
    "missing-member": ([[0, 1], [2, 3]], "exactly once"),
}


@pytest.mark.parametrize("case", list(HIER_CASES))
def test_hierarchical_aggregate_matches_reference(case):
    jax = pytest.importorskip("jax")
    from repro.core import aggregation as j_agg

    cells, err = HIER_CASES[case]
    trees, w = _trees(0, 5), [855.0, 134.0, 310.0, 1381.0, 1077.0]
    jtrees = [jax.tree.map(jax.numpy.asarray, t) for t in trees]
    ttrees = [bridge.to_torch(t, "cpu") for t in trees]
    if err is not None:
        for fn, args in ((j_agg.hierarchical_aggregate, jtrees),
                         (t_agg.hierarchical_aggregate, ttrees)):
            with pytest.raises(ValueError, match=err):
                fn(args, w, cells)
        return
    jfull, jsum, jmass = j_agg.hierarchical_aggregate(jtrees, w, cells)
    tfull, tsum, tmass = t_agg.hierarchical_aggregate(ttrees, w, cells)
    _assert_equal_tree(tfull, jfull)
    assert tmass == jmass and len(tsum) == len(jsum)
    for a, b in zip(tsum, jsum):
        _assert_equal_tree(a, b)


ANCHORED_CASES = {
    "absent-mass": ([[0, 2], [1]], [500.0, 0.0], None),
    "absent-only-cell": ([[0, 1, 2], []], [0.0, 300.0], None),
    "no-absent": ([[0], [1, 2]], [0.0, 0.0], None),
    "skipped-cell": ([[0, 1, 2], [], []], [10.0, 0.0, 20.0], None),
    "negative-mass": ([[0, 1, 2]], [-1.0], ">= 0"),
    "mass-per-cell": ([[0, 1, 2]], [1.0, 2.0], "one absent-mass"),
    "shared": ([[0, 1], [1, 2]], [0.0, 0.0], "must not share"),
}


@pytest.mark.parametrize("case", list(ANCHORED_CASES))
def test_anchored_hierarchical_aggregate_matches_reference(case):
    jax = pytest.importorskip("jax")
    from repro.core import aggregation as j_agg

    cells, absent, err = ANCHORED_CASES[case]
    glob, *contribs = _trees(1, 4)
    w = [310.0, 1381.0, 243.0]
    jargs = (jax.tree.map(jax.numpy.asarray, glob),
             [jax.tree.map(jax.numpy.asarray, t) for t in contribs])
    targs = (bridge.to_torch(glob, "cpu"), [bridge.to_torch(t, "cpu") for t in contribs])
    if err is not None:
        for fn, (g, c) in ((j_agg.anchored_hierarchical_aggregate, jargs),
                           (t_agg.anchored_hierarchical_aggregate, targs)):
            with pytest.raises(ValueError, match=err):
                fn(g, c, w, cells, absent)
        return
    jfull, jsum, jmass = j_agg.anchored_hierarchical_aggregate(*jargs, w, cells, absent)
    tfull, tsum, tmass = t_agg.anchored_hierarchical_aggregate(*targs, w, cells, absent)
    _assert_equal_tree(tfull, jfull)
    assert tmass == jmass and len(tsum) == len(jsum)
    for a, b in zip(tsum, jsum):
        _assert_equal_tree(a, b)


def test_cohort_adapter_store_matches_reference():
    """Slots materialized from one standing global, the fresh views of an
    untouched client, the byte counts, and the two global swaps."""
    jax = pytest.importorskip("jax")
    from repro.core import splitfl as j_splitfl
    from repro.optim import AdamW as JAdamW

    glob, new = _trees(2, 2)
    head = np.random.default_rng(3).standard_normal((16, 6)).astype(np.float32)
    cuts = [1, 2, 1, 3, 2]
    jspec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), glob)
    js = j_splitfl.CohortAdapterStore(jspec, JAdamW(1e-3),
                                      jax.tree.map(jax.numpy.asarray, glob),
                                      jax.numpy.asarray(head), lambda u: cuts[u])
    tglob = bridge.to_torch(glob, "cpu")
    ts = CohortAdapterStore(tree_map(torch.zeros_like, tglob), AdamW(1e-3), tglob,
                            torch.from_numpy(head), lambda u: cuts[u])
    for u in (3, 0, 4):
        jslot, tslot = js.materialize(u), ts.materialize(u)
        _assert_equal_tree(tslot, jslot)
    assert ts.touched() == js.touched() == [0, 3, 4]
    assert ts.peek(1) is None and ts.materialize(0) is ts.slot(0)
    for cut in (1, 2, 3):
        assert ts.slot_nbytes(cut) == js.slot_nbytes(cut)
        for a, b in zip(ts.fresh_views(cut), js.fresh_views(cut)):
            _assert_equal_tree(a, b)
    assert ts.resident_nbytes() == js.resident_nbytes() > 0
    # untouched trees alias the template until a step replaces them
    assert ts.slot(0)["head"] is ts.global_head
    ts.drop(3)
    js.drop(3)
    assert ts.touched() == js.touched() == [0, 4]
    tnew = bridge.to_torch(new, "cpu")
    ts.set_global(tnew, torch.zeros(16, 6))
    assert ts.touched() == [0, 4]
    _assert_equal_tree(ts.fresh_views(2)[0], t_lora.split_lora(tnew, 2)[0])
    ts.reset_global(tnew, torch.zeros(16, 6))
    assert ts.touched() == [] and ts.resident_nbytes() == 0.0


def test_trainer_ledger_prices_resident_bytes(data):
    """Obs on: the memory ledger carries the cohort-resident bytes and the
    metrics see the commits, with the timeline untouched."""
    from repro_torch.obs import MemoryLedger, MetricsRegistry, Observability

    train, test = data
    spec = T.FleetSpec(**SPEC)
    mk = ROWS["pareto-vmap-flat"]
    off = train_population(_cfg(), spec.population(), mk(T), train, test, device="cpu")
    obs = Observability(metrics=MetricsRegistry(),
                        ledger=MemoryLedger(np.full(spec.n, 100.0), np.ones(spec.n),
                                            np.ones(spec.n), 50.0))
    on = train_population(_cfg(), spec.population(), mk(T), train, test, obs=obs,
                          device="cpu")
    assert on.loss_events == off.loss_events
    assert on.clock_result.makespan == off.clock_result.makespan
    assert obs.metrics.counter_value("commits") > 0
    assert obs.ledger.server_peak() > 50.0


def test_chip_smoke_population_prediction_is_pinned():
    """``chip_smoke.py --predict-population`` replays the [population]
    phase's runs on the CPU at bert-base's full-width timing (the exact
    runs' trainer held against the Simulator bit for bit there too).  Its
    last output, the ``PREDICTED_POPULATION`` literal, is the text the
    script holds the card's runs to; both exact runs serve some chunk, so
    the cohort steps' grouped kernel runs on them."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script), "--predict-population"],
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    printed = out[out.index("PREDICTED_POPULATION = "):].rstrip("\n")
    source = script.read_text()
    start = source.index("PREDICTED_POPULATION = {")
    assert source[start:source.index("\n\n\n", start)] == printed
    runs = {line.split("] ", 1)[0][len("[predict:population:"):]:
            json.loads(line.split("] ", 1)[1])
            for line in out.splitlines() if line.startswith("[predict:population:")}
    assert sorted(runs) == ["exact:async", "exact:sync", "scale", "sim"]
    assert all(run["launches"]["grouped_lora_chunk"] > 0 for run in runs.values())
    assert runs["sim"]["stragglers"] and runs["sim"]["launches"]["quantize_rows"] > 0
    assert [len(c) for c in runs["scale"]["cohorts"]] == [30, 30, 30]
