"""The whole slice: the port's federated Simulator against the JAX package's,
from the reference's own initial state (``bridge.load_reference_state``),
at reduced(bert-base, 4 layers, d 128), vocab 4096, seq 16, batch 4, the six
paper clients at cuts (1,1,2,2,3,3), 2 rounds, aggregation every 2 — one
aggregation and one evaluation — on the paper's sequential server and on
the cohort-batched ragged server with int8+EF links (the vmap cohort step:
tests/test_torch_vmap_simulator.py).  Also: the fleet knobs, which raised
until the population slice (tests/test_torch_population.py), now build
and act, and the numpy bridge round-trips.  The event
engine's parity is tests/test_torch_event.py.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import make_emotion_dataset
from repro_torch.fed import (PAPER_CLIENTS, AggConfig, ControlConfig, EngineConfig,
                             FedRunConfig, FleetConfig, NetConfig, ObsConfig, Simulator)
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamWState

set_fp32_policy()

CUTS = (1, 1, 2, 2, 3, 3)
LR = 1e-3
RUN_KW = dict(rounds=2, batch_size=4, seq_len=16, lr=LR)
# a mean loss computed after AdamW steps: the optimizer's first step moves an
# element with a near-zero gradient by about lr either way (ROADMAP Queue
# C.1); measured differences are ~1e-7, far inside this bound
LOSS_RTOL = 1e-4
# adapters after two AdamW steps (one per round) and one aggregation
ADAPTER_ATOL = 2 * LR * 2


def _datasets(make):
    return (make(600, seq_len=16, vocab_size=4096, seed=0),
            make(120, seq_len=16, vocab_size=4096, seed=1))


def _port_cfg():
    return reduced(REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)


def _leaf_max_diff(got, want):
    if isinstance(got, dict):
        return max(_leaf_max_diff(got[k], want[k]) for k in got)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_simulator_matches_reference():
    """Both packages route every adapted projection through their fused
    kernel (the reference's Pallas kernel in interpret mode)."""
    jax = pytest.importorskip("jax")
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make
    from repro.fed import AggConfig as JAgg
    from repro.fed import EngineConfig as JEngine
    from repro.fed import FedRunConfig as JRun
    from repro.fed import PAPER_CLIENTS as J_CLIENTS
    from repro.fed import Simulator as JSimulator

    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)
    js = JSimulator(jcfg, J_CLIENTS, CUTS, *_datasets(j_make),
                    JRun(**RUN_KW, engine=JEngine(fused_lora=True), agg=JAgg(interval=2)))
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    j_hist = js.run_training()

    ts = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, *_datasets(make_emotion_dataset),
                   FedRunConfig(**RUN_KW, engine=EngineConfig(fused_lora=True),
                                agg=AggConfig(interval=2)),
                   device="cpu")
    bridge.load_reference_state(ts, state)
    t_hist = ts.run_training()

    assert [r.round for r in t_hist] == [r.round for r in j_hist] == [0, 1]
    assert ts.data_sizes == js.data_sizes
    for t, j in zip(t_hist, j_hist):
        assert abs(t.sim_time_s - j.sim_time_s) <= 1e-12
        assert abs(t.mean_loss - j.mean_loss) <= LOSS_RTOL * abs(j.mean_loss)
    # logits agree to ~1e-6, and no argmax of this seeded test set sits that
    # close to a tie, so the evaluation counts the same hits
    assert t_hist[-1].accuracy == j_hist[-1].accuracy
    assert t_hist[-1].f1 == j_hist[-1].f1
    for u in range(len(CUTS)):
        assert _leaf_max_diff(ts.client_lora[u], js.client_lora[u]) <= ADAPTER_ATOL
        assert _leaf_max_diff(ts.server_lora[u], js.server_lora[u]) <= ADAPTER_ATOL
    assert _leaf_max_diff(ts.heads[0], js.heads[0]) <= ADAPTER_ATOL


def test_cohort_quantized_simulator_matches_reference():
    """All six clients form one dispatch chunk, which the ragged step splits
    into three cut groups of two; activations go up as int8 with error
    feedback and gradients come down as int8.  Both packages route every
    adapted projection through their grouped or fused kernel (the
    reference's Pallas kernels in interpret mode)."""
    jax = pytest.importorskip("jax")
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make
    from repro.fed import AggConfig as JAgg
    from repro.fed import EngineConfig as JEngine
    from repro.fed import FedRunConfig as JRun
    from repro.fed import NetConfig as JNet
    from repro.fed import PAPER_CLIENTS as J_CLIENTS
    from repro.fed import Simulator as JSimulator

    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)
    js = JSimulator(jcfg, J_CLIENTS, CUTS, *_datasets(j_make),
                    JRun(**RUN_KW, engine=JEngine(cohort_chunk=6, cohort_impl="ragged",
                                                  fused_lora=True),
                         net=JNet(quantize=True), agg=JAgg(interval=2)))
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    j_hist = js.run_training()

    ts = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, *_datasets(make_emotion_dataset),
                   FedRunConfig(**RUN_KW, engine=EngineConfig(cohort_chunk=6,
                                                              cohort_impl="ragged",
                                                              fused_lora=True),
                                net=NetConfig(quantize=True), agg=AggConfig(interval=2)),
                   device="cpu")
    bridge.load_reference_state(ts, state)
    assert ts._service_plan() == [list(g) for g in js._service_plan()] and \
        len(ts._service_plan()) == 1
    t_hist = ts.run_training()

    assert [r.round for r in t_hist] == [r.round for r in j_hist] == [0, 1]
    for t, j in zip(t_hist, j_hist):
        assert abs(t.sim_time_s - j.sim_time_s) <= 1e-12
        assert abs(t.mean_loss - j.mean_loss) <= LOSS_RTOL * abs(j.mean_loss)
    assert t_hist[-1].accuracy == j_hist[-1].accuracy
    assert t_hist[-1].f1 == j_hist[-1].f1
    for u in range(len(CUTS)):
        assert _leaf_max_diff(ts.client_lora[u], js.client_lora[u]) <= ADAPTER_ATOL
        assert _leaf_max_diff(ts.server_lora[u], js.server_lora[u]) <= ADAPTER_ATOL
        # the uplink residual is x - dequantize(quantize(x)): where round 2's
        # activations (after AdamW, Queue C.1) land on the other side of a
        # rounding boundary, q moves one level and the residual one step, so
        # a few elements in a thousand may differ by a step; the rest agree
        t_res, j_res = ts._ef_residual[u].numpy(), np.asarray(js._ef_residual[u])
        d = np.abs(t_res - j_res)
        assert (d > 1e-5).sum() <= 1e-3 * d.size
        assert d.max() <= 2 * max(np.abs(t_res).max(), np.abs(j_res).max())
    # int8 links shrink both transfers: a quicker simulated round than the
    # sequential run's float32 links (test above: 0.0058 s for round 1)
    assert t_hist[0].sim_time_s < 0.005


def test_heads_are_shared_after_commit_but_never_written_through():
    ts = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, *_datasets(make_emotion_dataset),
                   FedRunConfig(**RUN_KW, agg=AggConfig(interval=1)), device="cpu")
    ts.run_round(0)
    shared = ts.heads[0]
    assert all(h is shared for h in ts.heads)
    before = shared.clone()
    ts._serve_group([0])                       # client 0's server step
    assert ts.heads[0] is not shared and torch.equal(shared, before)
    assert all(h is shared for h in ts.heads[1:])


def _run(**groups):
    kw = dict(RUN_KW)
    kw.update(groups)
    return FedRunConfig(**kw)


@pytest.mark.parametrize("run,knob", [
    # each configuration pairs a knob ported by an earlier slice with a
    # fleet knob that raised until the population slice ported it: every
    # one now builds, and its fleet knob is live
    pytest.param(_run(engine=EngineConfig(mode="event", cohort_chunk=2), snapshot_every=1.0,
                      snapshot_dir="snapshots", fleet=FleetConfig(edge_cells=2)),
                 "edge_cells", id="event"),
    pytest.param(_run(engine=EngineConfig(cohort_chunk=2),
                      fleet=FleetConfig(sampling="uniform", rate=0.5)), "sampling",
                 id="cohort_chunk"),
    pytest.param(_run(engine=EngineConfig(mode="event", cohort_chunk=2),
                      control=ControlConfig(policy="periodic"),
                      fleet=FleetConfig(straggler_prob=0.1)), "straggler_prob",
                 id="control"),
    pytest.param(_run(engine=EngineConfig(mode="event"), obs=ObsConfig(metrics=True),
                      preempt_at=0.5, fleet=FleetConfig(straggler_prob=0.1)),
                 "straggler_prob", id="obs"),
    pytest.param(_run(engine=EngineConfig(mode="event"), agg=AggConfig(transport="plane"),
                      resume_from="snapshots", fleet=FleetConfig(edge_cells=2)),
                 "edge_cells", id="plane"),
    pytest.param(_run(fleet=FleetConfig(sampling="uniform", rate=0.5)), "sampling",
                 id="sampling"),
    pytest.param(_run(fleet=FleetConfig(straggler_prob=0.1)), "straggler_prob",
                 id="stragglers"),
    pytest.param(_run(fleet=FleetConfig(edge_cells=2)), "edge_cells", id="edge_cells"),
])
def test_knobs_outside_the_slice_raise(run, knob, tmp_path, monkeypatch):
    """No knob of the Simulator is outside the port any more: each of
    these configurations builds (the snapshot knobs' directory goes to a
    temporary one), and its fleet knob acts — a sampled cohort of three,
    a straggler roll on the round stream for every client, two edge cells
    of three."""
    monkeypatch.chdir(tmp_path)
    train, test = _datasets(make_emotion_dataset)
    sim = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, train, test, run, device="cpu")
    if knob == "sampling":
        sim._sample_cohort()
        assert len(sim._active) == 3 and set(sim._active) < set(range(6))
    elif knob == "straggler_prob":
        want = np.random.default_rng(run.seed + 7777).random(6) < 0.1
        got = [st.t_f != base.t_f for st, base in zip(sim._adjusted_times(), sim.times)]
        assert got == want.tolist()
    else:
        assert [list(c) for c in sim._edges.cells] == [[0, 1, 2], [3, 4, 5]]


def test_memory_report_and_custom_links_raise():
    """A FleetSpec fleet builds the Simulator's devices and cuts (its
    parity with the reference: tests/test_torch_population.py); links=
    outside link_model='custom' is
    refused as in the reference; the memory report is ported (compared
    with the reference's in tests/test_torch_sl.py) and reports this run."""
    from repro_torch.core import memory_model
    from repro_torch.fed import FleetSpec

    train, test = _datasets(make_emotion_dataset)
    spec = FleetSpec(n=6, seed=1)
    sim = Simulator(_port_cfg(), train=train, test=test, run=_run(), fleet=spec, device="cpu")
    assert sim.cuts == list(CUTS) and sim.u == 6
    with pytest.raises(ValueError, match="link_model='custom'"):
        Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, train, test, _run(),
                  links=[object()] * 6, device="cpu")
    sim = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, train, test, _run(), device="cpu")
    assert sim.server_memory_report() == memory_model.server_memory(
        sim.cfg, "ours", CUTS, RUN_KW["batch_size"], RUN_KW["seq_len"])


def test_bridge_round_trip_keeps_paths_and_dtypes():
    rs = np.random.default_rng(0)
    tree = {"layers": {"attn": {"wq": {"a": rs.standard_normal((2, 4, 8)).astype(np.float32),
                                       "b": np.zeros((2, 8, 4), np.float32)}}},
            "tokens": rs.integers(0, 9, (3, 5)).astype(np.int32)}
    opt = AdamWState(np.int32(3), tree["layers"], tree["layers"])
    back = bridge.to_numpy(bridge.to_torch({"t": tree, "opt": opt}, "cpu"))
    assert isinstance(back["opt"], AdamWState) and back["opt"].step.dtype == np.int32
    np.testing.assert_array_equal(back["t"]["tokens"], tree["tokens"])
    assert back["t"]["tokens"].dtype == np.int32
    np.testing.assert_array_equal(back["t"]["layers"]["attn"]["wq"]["a"],
                                  tree["layers"]["attn"]["wq"]["a"])
    with pytest.raises(KeyError):
        bridge.load_reference_state(None, {"params": {}})


def test_fused_and_einsum_runs_agree_on_cpu():
    """On the CPU the fused wrapper runs the plain version, so the two
    paths give the same history."""
    hists = []
    for fused in (False, True):
        sim = Simulator(_port_cfg(), PAPER_CLIENTS, CUTS, *_datasets(make_emotion_dataset),
                        FedRunConfig(**RUN_KW, engine=EngineConfig(fused_lora=fused),
                                     agg=AggConfig(interval=2)), device="cpu")
        hists.append([dataclasses.astuple(r) for r in sim.run_training()])
    assert hists[0] == hists[1]
    assert all(np.isfinite(r[2]) for r in hists[0])

