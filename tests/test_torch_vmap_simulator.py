"""The port's Simulator with the vmap cohort step (``EngineConfig(
cohort_chunk=3, cohort_impl="vmap")``, the reference's default cohort
impl) against the JAX package's, from the reference's own initial state
(``bridge.load_reference_state``), at reduced(bert-base, 4 layers, d 128),
vocab 4096, seq 16, batch 4, the six paper clients at cuts
(1,1,2,2,3,3), 2 rounds: under the analytic engine (the service plan's
chunks of 3), event sync waves, buffered async commits and a periodic
controller, each fused (the reference's Pallas kernel in interpret mode)
and einsum.  Under the event engine the server runs a thousand times
slower than the paper's, so uploads queue and the clock serves chunks of
mixed cuts; the controlled run migrates every client to cut 3 mid-run.

Tolerances as in tests/test_torch_simulator.py: simulated times, loss-event
keys, served chunks, discards and control decisions exactly (pinned
copies of the engine and cost model); losses within 1e-4 relative;
adapters within 2*lr per AdamW step and aggregation.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch import fed as t_fed
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import make_emotion_dataset
from repro_torch.numerics import set_fp32_policy

set_fp32_policy()

CUTS = (1, 1, 2, 2, 3, 3)
LR = 1e-3
RUN_KW = dict(rounds=2, batch_size=4, seq_len=16, lr=LR)
LOSS_RTOL = 1e-4
ADAPTER_ATOL = 2 * LR * 2
SERVER_LOAD = 1000.0


def _datasets(make):
    return (make(600, seq_len=16, vocab_size=4096, seed=0),
            make(120, seq_len=16, vocab_size=4096, seed=1))


def _port_cfg():
    return reduced(REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)


def _leaf_max_diff(got, want):
    if isinstance(got, dict):
        return max(_leaf_max_diff(got[k], want[k]) for k in got)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


# the vmap cohort step (the reference's default cohort_impl) in chunks of 3
# with mixed cuts, under each engine the Simulator drives it from
VMAP_CASES = {
    "analytic": {"engine": dict(), "agg": dict(interval=2)},
    "event_sync": {"engine": dict(mode="event"), "agg": dict(interval=1)},
    "buffered": {"engine": dict(mode="event"),
                 "agg": dict(policy="buffered", interval=1, max_inflight=2, buffer_k=3)},
    "control_periodic": {"engine": dict(mode="event"), "agg": dict(interval=1),
                         "control": dict(policy="periodic", resolve_every=1)},
}


def _server(fed, case):
    srv = fed.SERVER
    if case["engine"].get("mode") == "event":
        srv = dataclasses.replace(srv, utilization=srv.utilization / SERVER_LOAD)
    return srv


def _vmap_run(fed, case, fused):
    kw = dict(RUN_KW)
    kw["engine"] = fed.EngineConfig(cohort_chunk=3, cohort_impl="vmap", fused_lora=fused,
                                    **case["engine"])
    kw["agg"] = fed.AggConfig(**case["agg"])
    if "control" in case:
        kw["control"] = fed.ControlConfig(**case["control"])
    return fed.FedRunConfig(**kw)


def _loss_close(got: float, want: float) -> bool:
    if np.isnan(want):
        return bool(np.isnan(got))
    return abs(got - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
@pytest.mark.parametrize("name", list(VMAP_CASES))
def test_vmap_cohort_simulator_matches_reference(name, fused):
    """Loss events, simulated times, accuracy and adapters of the port's
    Simulator with cohort_impl='vmap' against the JAX Simulator's, from the
    reference's initial state; the reference runs its Pallas kernel in
    interpret mode where fused."""
    jax = pytest.importorskip("jax")
    from repro import fed as j_fed
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make

    case = VMAP_CASES[name]
    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=4, d_model=128).with_(vocab_size=4096)
    js = j_fed.Simulator(jcfg, j_fed.PAPER_CLIENTS, CUTS, *_datasets(j_make),
                         _vmap_run(j_fed, case, fused), server=_server(j_fed, case))
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    js.run_training()
    ts = t_fed.Simulator(_port_cfg(), t_fed.PAPER_CLIENTS, CUTS,
                         *_datasets(make_emotion_dataset), _vmap_run(t_fed, case, fused),
                         server=_server(t_fed, case), device="cpu")
    bridge.load_reference_state(ts, state)
    ts.run_training()

    # chunks of 3 mix the cuts, so a vmap dispatch masks its lanes apart
    if "mode" not in case["engine"]:
        assert any(len({CUTS[u] for u in grp}) > 1 for grp in ts._service_plan())
    j_hist, t_hist = js.history, ts.history
    assert [r.round for r in t_hist] == [r.round for r in j_hist] and t_hist
    assert [r.sim_time_s for r in t_hist] == [r.sim_time_s for r in j_hist]
    for t, j in zip(t_hist, j_hist):
        assert _loss_close(t.mean_loss, j.mean_loss), (t, j)
        assert (t.accuracy, t.f1) == (j.accuracy, j.f1)
    assert [e[:3] for e in ts.loss_events] == [e[:3] for e in js.loss_events]
    for t, j in zip(ts.loss_events, js.loss_events):
        assert _loss_close(t[3], j[3]), (t, j)
    assert ts.discarded_updates == js.discarded_updates
    if case["engine"].get("mode") == "event":
        tr, jr = ts.clock_result, js.clock_result
        assert [dataclasses.astuple(e) for e in tr.serves] == \
            [dataclasses.astuple(e) for e in jr.serves]
        assert any(len({CUTS[u] for u in e.uids}) > 1 for e in tr.serves)
    if "control" in case:
        assert [dataclasses.asdict(e) for e in ts.control_events] == \
            [dataclasses.asdict(e) for e in js.control_events]
        assert any(ev.applied and ev.cut_changes for ev in ts.control_events)
        assert ts.cuts == js.cuts and ts.cuts != list(CUTS)
    for u in range(len(CUTS)):
        assert _leaf_max_diff(ts.client_lora[u], js.client_lora[u]) <= ADAPTER_ATOL
        assert _leaf_max_diff(ts.server_lora[u], js.server_lora[u]) <= ADAPTER_ATOL
