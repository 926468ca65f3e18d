"""Population scale in the port's Simulator: FleetSpec fleets, sampled
cohorts, stragglers and edge cells.

Against the JAX Simulator, from the reference's own initial state
(``bridge.load_reference_state``), at reduced(bert-base, 4 layers, d 128),
vocab 4096, seq 16, batch 4: uniform sampling with stragglers and edge
cells by blocks under the analytic engine; Pareto sampling with stragglers
and k-means edge cells of a ``FleetSpec`` under the event engine's sync
waves, adapter syncs through the network plane; buffered async commits with
stragglers.  Each case's cohorts, straggler draws (the two rng streams'
positions) and simulated times are equal, losses within LOSS_RTOL and
adapters within ADAPTER_ATOL.  The analytic engine's closed-form two-tier
commit legs equal the reference's.  Port only: a sampled event run killed
and resumed continues bit for bit; the knobs that were refused before this
slice now run.  On the card: sampled fused rounds with their launches
counted.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import json

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import make_emotion_dataset
from repro_torch import fed as T
from repro_torch.kernels.grouped_lora import grouped_lora_chunk
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.quant import quantize_rows
from repro_torch.numerics import set_fp32_policy
from repro_torch.tree import tree_leaves

set_fp32_policy()

LR = 1e-3
RUN_KW = dict(rounds=2, batch_size=4, seq_len=16, lr=LR)
# mean losses after AdamW steps: the optimizer's first step moves an element
# with a near-zero gradient by about lr either way (ROADMAP Queue C)
LOSS_RTOL = 1e-4
# adapters after two AdamW steps and the commits
ADAPTER_ATOL = 2 * LR * 2
SPEC = dict(n=6, seed=0, link_model="constant")
ONE_CUT = (2,) * 6      # one distinct cut: one set of reference steps to compile


def _datasets(make):
    return (make(600, seq_len=16, vocab_size=4096, seed=0),
            make(120, seq_len=16, vocab_size=4096, seed=1))


def _cfg():
    return reduced(REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)


def _analytic_blocks(M):
    return M.FedRunConfig(**RUN_KW, engine=M.EngineConfig(mode="analytic"),
                          agg=M.AggConfig(policy="sync", interval=1),
                          fleet=M.FleetConfig(sampling="uniform", rate=0.5,
                                              straggler_prob=0.3, edge_cells=2))


def _event_kmeans(M, **knobs):
    return M.FedRunConfig(**RUN_KW, **knobs,
                          engine=M.EngineConfig(mode="event", slots=2, cohort_chunk=2,
                                                cohort_impl="ragged"),
                          agg=M.AggConfig(policy="sync", interval=1, transport="plane"),
                          net=M.NetConfig(link_model="custom"),
                          fleet=M.FleetConfig(sampling="pareto", rate=0.5,
                                              straggler_prob=0.3, edge_cells=2,
                                              cell_assignment="kmeans"))


def _buffered(M, **knobs):
    return M.FedRunConfig(**RUN_KW, **knobs, engine=M.EngineConfig(mode="event"),
                          agg=M.AggConfig(policy="buffered", interval=1, buffer_k=3,
                                          max_inflight=2),
                          fleet=M.FleetConfig(straggler_prob=0.3))


# (run config by package, fleet: a FleetSpec or the paper clients at ONE_CUT)
CASES = {"analytic-uniform-blocks": (_analytic_blocks, False),
         "event-pareto-kmeans": (_event_kmeans, True),
         "buffered-stragglers": (_buffered, False)}


def _simulator(M, case, cfg, device=None):
    mk, with_fleet = CASES[case]
    train, test = _datasets(make_emotion_dataset if M is T else _reference_make())
    kw = {} if device is None else {"device": device}
    if with_fleet:
        return M.Simulator(cfg, fleet=M.FleetSpec(**SPEC), train=train, test=test,
                           run=mk(M), **kw)
    return M.Simulator(cfg, M.PAPER_CLIENTS, ONE_CUT, train, test, mk(M), **kw)


def _reference_make():
    from repro.data import make_emotion_dataset as j_make
    return j_make


def _reference_cfg():
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    return j_reduced(J_REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)


def _leaf_max_diff(got, want):
    if isinstance(got, dict):
        return max(_leaf_max_diff(got[k], want[k]) for k in got)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def _drive(sim, rounds):
    """Run the configured rounds; under the analytic engine one round at a
    time, recording each round's sampled cohort."""
    if sim.run.engine.mode == "event":
        sim.run_training()
        return []
    cohorts = []
    for rnd in range(rounds):
        sim.run_round(rnd)
        cohorts.append(list(sim._active))
    return cohorts


@pytest.mark.parametrize("case", list(CASES))
def test_simulator_matches_reference(case):
    jax = pytest.importorskip("jax")
    from repro import fed as J

    js = _simulator(J, case, _reference_cfg())
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    ts = _simulator(T, case, _cfg(), device="cpu")
    bridge.load_reference_state(ts, state)
    assert ts.data_sizes == js.data_sizes
    j_cohorts = _drive(js, RUN_KW["rounds"])
    t_cohorts = _drive(ts, RUN_KW["rounds"])

    # cohorts, straggler draws and simulated times: bit for bit
    assert t_cohorts == j_cohorts
    assert ts._round_rng.bit_generator.state == js._round_rng.bit_generator.state
    assert ts._async_rng.bit_generator.state == js._async_rng.bit_generator.state
    assert [e[:3] for e in ts.loss_events] == [e[:3] for e in js.loss_events]
    assert ts.discarded_updates == js.discarded_updates
    assert [(r.round, r.sim_time_s) for r in ts.history] == \
        [(r.round, r.sim_time_s) for r in js.history]
    for t, j in zip(ts.history, js.history):
        if np.isnan(j.mean_loss):
            assert np.isnan(t.mean_loss)
        else:
            assert abs(t.mean_loss - j.mean_loss) <= LOSS_RTOL * abs(j.mean_loss)
    for (_, _, _, tl), (_, _, _, jl) in zip(ts.loss_events, js.loss_events):
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    if case == "analytic-uniform-blocks":
        assert [len(c) for c in t_cohorts] == [3, 3]        # rate 0.5 of six
    else:
        assert ts.loss_events
    # the event runs' sampled cohorts: a round served only its cohort
    if case == "event-pareto-kmeans":
        served = [sorted(e[1] for e in ts.loss_events if e[2] == r) for r in range(2)]
        assert all(len(s) == 3 for s in served)
    if ts._edges is not None:
        assert ts._edges.cells == js._edges.cells
        assert len(ts.edge_summaries) == len(js.edge_summaries)
        assert ts.edge_masses == js.edge_masses
    assert _leaf_max_diff(ts._global_full, js._global_full) <= ADAPTER_ATOL
    assert _leaf_max_diff(ts._global_head, js._global_head) <= ADAPTER_ATOL
    for u in range(ts.u):
        assert _leaf_max_diff(ts.client_lora[u], js.client_lora[u]) <= ADAPTER_ATOL
        assert _leaf_max_diff(ts.server_lora[u], js.server_lora[u]) <= ADAPTER_ATOL


@pytest.mark.parametrize("cells", ["blocks", "kmeans"])
def test_analytic_plane_edge_commit_matches_reference(cells):
    """The analytic engine prices a two-tier commit through the plane in
    closed form (cell uplinks, the backhaul, then the downlinks): equal to
    the reference's for the same fleet and cells, and later than the flat
    commit's legs."""
    pytest.importorskip("jax")
    from repro import fed as J

    def mk(M, edge_cells):
        return M.FedRunConfig(**RUN_KW, engine=M.EngineConfig(mode="analytic"),
                              agg=M.AggConfig(transport="plane"),
                              net=M.NetConfig(link_model="custom"),
                              fleet=M.FleetConfig(
                                  edge_cells=edge_cells,
                                  cell_assignment=cells if edge_cells > 1 else "blocks"))

    train, test = _datasets(make_emotion_dataset)
    jtrain, jtest = _datasets(_reference_make())
    got = T.Simulator(_cfg(), fleet=T.FleetSpec(**SPEC), train=train, test=test,
                      run=mk(T, 3), device="cpu")
    want = J.Simulator(_reference_cfg(), fleet=J.FleetSpec(**SPEC), train=jtrain,
                       test=jtest, run=mk(J, 3))
    flat = T.Simulator(_cfg(), fleet=T.FleetSpec(**SPEC), train=train, test=test,
                       run=mk(T, 1), device="cpu")
    assert got._edges.cells == want._edges.cells
    assert got._commit_sync(None) == want._commit_sync(None)
    assert got._commit_sync(None) > flat._commit_sync(None)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", ["event-pareto-kmeans", "buffered-stragglers"])
def test_sampled_run_killed_and_resumed_continues_bit_for_bit(case, tmp_path):
    """A snapshot carries the round and async streams' positions, so a run
    that samples cohorts and rolls stragglers continues after a kill and a
    resume in a fresh Simulator exactly as the uninterrupted run."""
    mk_run, with_fleet = CASES[case]
    train, test = _datasets(make_emotion_dataset)

    def mk(**knobs):
        run = mk_run(T, **knobs)
        if with_fleet:
            return T.Simulator(_cfg(), fleet=T.FleetSpec(**SPEC), train=train, test=test,
                               run=run, device="cpu")
        return T.Simulator(_cfg(), T.PAPER_CLIENTS, ONE_CUT, train, test, run,
                           device="cpu")

    ref = mk()
    ref.run_training()
    span = ref._clock.now
    snap_dir = str(tmp_path / "snaps")
    killed = mk(snapshot_every=span * 0.3, snapshot_dir=snap_dir, preempt_at=span * 0.7)
    killed.run_training()
    assert killed.clock_result.preempted and killed.loss_events
    resumed = mk(resume_from=snap_dir)
    resumed.run_training()
    assert not resumed.clock_result.preempted
    assert resumed._clock.now == ref._clock.now
    assert json.dumps(resumed._clock.state_dict(), sort_keys=True) == \
        json.dumps(ref._clock.state_dict(), sort_keys=True)
    np.testing.assert_equal([dataclasses.astuple(r) for r in resumed.history],
                            [dataclasses.astuple(r) for r in ref.history])
    assert resumed.loss_events == ref.loss_events
    assert resumed.discarded_updates == ref.discarded_updates
    assert resumed._round_rng.bit_generator.state == ref._round_rng.bit_generator.state
    assert resumed._async_rng.bit_generator.state == ref._async_rng.bit_generator.state
    assert _equal_trees(resumed._global_full, ref._global_full)
    assert _equal_trees(resumed._global_head, ref._global_head)


def test_fleet_knobs_and_their_errors():
    """``fleet=`` builds devices, cuts and custom links from one FleetSpec;
    it refuses explicit devices beside it and a fleet size that disagrees;
    k-means cells need a FleetSpec's coordinates."""
    train, test = _datasets(make_emotion_dataset)
    spec = T.FleetSpec(**SPEC)
    run = T.FedRunConfig(**RUN_KW, net=T.NetConfig(link_model="custom"))
    sim = T.Simulator(_cfg(), fleet=spec, train=train, test=test, run=run, device="cpu")
    assert sim.cuts == spec.cuts()
    assert [d.tflops for d in sim.devices] == [d.tflops for d in spec.devices()]
    assert [ln.rate_mbps for ln in sim.network.uplinks] == \
        [ln.rate_mbps for ln in spec.links()]
    with pytest.raises(ValueError, match="not both"):
        T.Simulator(_cfg(), T.PAPER_CLIENTS, ONE_CUT, train, test, run, fleet=spec,
                    device="cpu")
    with pytest.raises(ValueError, match="fleet.size"):
        T.Simulator(_cfg(), fleet=spec, train=train, test=test, device="cpu",
                    run=dataclasses.replace(run, fleet=T.FleetConfig(size=5)))
    with pytest.raises(ValueError, match="kmeans"):
        T.Simulator(_cfg(), T.PAPER_CLIENTS, ONE_CUT, train, test, device="cpu",
                    run=T.FedRunConfig(**RUN_KW, fleet=T.FleetConfig(
                        edge_cells=2, cell_assignment="kmeans")))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_sampled_fused_rounds_count_launches(cuda_device):
    """On the card: two sampled event rounds with stragglers, k-means edge
    cells and int8 links, fused; every served client's forward and
    backward runs 2*T*cut - 3 ``lora_matmul`` and 2 ``quantize_rows``, a
    server dispatch of one client 2*T*(L - cut) ``lora_matmul``, a chunk
    2*T*(L - cut) ``grouped_lora`` per distinct cut, the evaluation T*L
    ``lora_matmul`` a batch."""
    train, test = _datasets(make_emotion_dataset)
    run = dataclasses.replace(
        _event_kmeans(T), engine=T.EngineConfig(mode="event", slots=2, cohort_chunk=2,
                                                cohort_impl="ragged", fused_lora=True),
        net=T.NetConfig(link_model="custom", quantize=True))
    sim = T.Simulator(_cfg(), fleet=T.FleetSpec(n=8, seed=0, link_model="constant"),
                      train=train, test=test, run=run, device=cuda_device)
    counters = ((lora_matmul, "launches"), (grouped_lora_chunk, "launches"),
                (quantize_rows, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    sim.run_training()
    t, nl = len(sim.cfg.lora.targets), sim.cfg.n_layers
    lm = gl = q = 0
    for ev in sim.clock_result.serves:
        lm += sum(2 * t * sim.cuts[u] - 3 for u in ev.uids)
        if len(ev.uids) == 1:
            lm += 2 * t * (nl - sim.cuts[ev.uids[0]])
        else:
            gl += sum(2 * t * (nl - c) for c in {sim.cuts[u] for u in ev.uids})
        q += 2 * len(ev.uids)
    n_batches = min(32, len(test) // RUN_KW["batch_size"])
    lm += sum(r.accuracy is not None for r in sim.history) * n_batches * t * nl
    assert [getattr(fn, attr) for fn, attr in counters] == [lm, gl, q]
    assert len(sim.loss_events) == 2 * 4 and all(np.isfinite(e[3]) for e in sim.loss_events)
