"""The event engine in the port against the JAX package's: both Simulators
from the reference's own initial state (``bridge.load_reference_state``)
at reduced(bert-base, 2 layers, d 256), vocab 4096, seq 16, batch 4, four
paper clients, under ``EngineConfig(mode="event")`` — sync barrier waves
(one server slot, or two with a deadline that drops a client), async
``buffered`` and ``staleness`` commits with two rounds in flight,
Gilbert-Elliott links on a shared cell with plane-routed adapter syncs,
links driven by the bundled bandwidth trace, caller-supplied links, the
closed-form plane transport under the analytic engine, ragged cohort chunks
that the clock forms, and the observability plane.

The engine, the network plane and the cost model are pinned copies, so the
simulated times, the loss events' (time, uid, round) keys, the discarded
updates and the Chrome trace are equal exactly; the losses agree within
1e-4 relative.  Also: the async aggregation functions against the
reference's on bridged trees.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch import fed as t_fed
from repro_torch import net as t_net
from repro_torch.configs import REGISTRY, reduced
from repro_torch.core import aggregation as t_agg
from repro_torch.data import make_emotion_dataset
from repro_torch.numerics import set_fp32_policy

set_fp32_policy()

N_CLIENTS = 4
CUTS = (1,) * N_CLIENTS
RUN_KW = dict(rounds=2, batch_size=4, seq_len=16, lr=1e-3)
# the port's Simulator parity tolerance (tests/test_torch_simulator.py): a
# mean loss after AdamW steps, far inside any step-1 flip (ROADMAP Queue C)
LOSS_RTOL = 1e-4
CAPACITY_MBPS = 150.0


def _datasets(make):
    return (make(400, seq_len=16, vocab_size=4096, seed=0),
            make(80, seq_len=16, vocab_size=4096, seed=1))


def _traces(net):
    """Client 0 reads the bundled CSV by path; the others take the same
    trace time-rotated, as the reference's example does."""
    bp, rates = net.bundled_trace()
    return [net.bundled_trace_path()] + [(bp, np.roll(rates, 17 * i).tolist())
                                         for i in range(1, N_CLIENTS)]


def _custom_links(net):
    return [net.ConstantLink(80.0),
            net.TraceLink([0.0, 0.01, 0.03], [40.0, 5.0, 120.0]),
            net.GilbertElliottLink(100.0, 10.0, p_gb=0.3, p_bg=0.5, dwell_s=0.003, seed=5),
            net.ConstantLink(25.0)]


def _async(policy, **kw):
    return {"agg": dict(policy=policy, interval=1, max_inflight=2, **kw)}


# each case: the run's groups by config class, and whether it passes links=
CASES = {
    "event_sync_fifo": {"engine": dict(mode="event", scheduler="fifo"),
                        "agg": dict(interval=2)},
    # two slots; the deadline drops client 0 from both waves (its
    # activations arrive last)
    "slots_deadline": {"engine": dict(mode="event", scheduler="wf", slots=2,
                                      deadline=0.0058),
                       "agg": dict(interval=1)},
    "buffered": {"engine": dict(mode="event"), **_async("buffered")},
    "staleness": {"engine": dict(mode="event"), **_async("staleness", staleness_alpha=0.7)},
    "gilbert_shared_plane": {"engine": dict(mode="event", fused_lora=True),
                             **_async("buffered", transport="plane"),
                             "net": dict(link_model="gilbert", shared=True,
                                         capacity_mbps=CAPACITY_MBPS, quantize=True)},
    "trace": {"engine": dict(mode="event"), "agg": dict(interval=1),
              "net": dict(link_model="trace", traces="bundled")},
    "custom_links": {"engine": dict(mode="event"), **_async("staleness"),
                     "net": dict(link_model="custom"), "links": True},
    "analytic_plane": {"engine": dict(mode="analytic"),
                       "agg": dict(interval=1, transport="plane")},
    "cohort_ragged": {"engine": dict(mode="event", cohort_chunk=2, cohort_impl="ragged",
                                     fused_lora=True),
                      **_async("buffered", buffer_k=3)},
    "obs": {"engine": dict(mode="event"), **_async("buffered"),
            "obs": dict(trace=True, metrics=True, memory_ledger=True)},
}


def _run_config(fed, net, case, trace_dir=None):
    groups = {"engine": fed.EngineConfig, "agg": fed.AggConfig, "net": fed.NetConfig,
              "obs": fed.ObsConfig}
    kw = dict(RUN_KW)
    for name, cls in groups.items():
        if name in case:
            args = dict(case[name])
            if args.get("traces") == "bundled":
                args["traces"] = _traces(net)
            if name == "obs" and trace_dir is not None:
                args["trace_dir"] = str(trace_dir)
            kw[name] = cls(**args)
    return fed.FedRunConfig(**kw)


def _reference(case, trace_dir=None):
    jax = pytest.importorskip("jax")
    from repro import fed as j_fed
    from repro import net as j_net
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make

    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=2, d_model=256).with_(vocab_size=4096)
    js = j_fed.Simulator(jcfg, j_fed.PAPER_CLIENTS[:N_CLIENTS], CUTS, *_datasets(j_make),
                         _run_config(j_fed, j_net, case, trace_dir),
                         links=_custom_links(j_net) if case.get("links") else None)
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    js.run_training()
    return js, state


def _port(case, state=None, trace_dir=None):
    ts = t_fed.Simulator(_port_cfg(), t_fed.PAPER_CLIENTS[:N_CLIENTS], CUTS,
                         *_datasets(make_emotion_dataset),
                         _run_config(t_fed, t_net, case, trace_dir),
                         links=_custom_links(t_net) if case.get("links") else None,
                         device="cpu")
    if state is not None:
        bridge.load_reference_state(ts, state)
    ts.run_training()
    return ts


def _port_cfg():
    return reduced(REGISTRY["bert-base"], n_layers=2, d_model=256).with_(vocab_size=4096)


def _close(got: float, want: float) -> bool:
    if math.isnan(want):
        return math.isnan(got)
    return abs(got - want) <= LOSS_RTOL * abs(want)


def _chrome_events(path):
    with open(path) as f:
        doc = json.load(f)
    return [(e.get("name"), e.get("ph"), e.get("pid"), e.get("tid"), e.get("ts"),
             e.get("dur")) for e in doc["traceEvents"]], doc.get("otherData", {})


@pytest.mark.parametrize("name", list(CASES))
def test_event_simulator_matches_reference(name, tmp_path):
    case = CASES[name]
    traced = "obs" in case
    js, state = _reference(case, tmp_path / "ref" if traced else None)
    ts = _port(case, state, tmp_path / "port" if traced else None)

    j_hist, t_hist = js.history, ts.history
    assert [r.round for r in t_hist] == [r.round for r in j_hist] and t_hist
    assert [r.sim_time_s for r in t_hist] == [r.sim_time_s for r in j_hist]
    assert ts.sim_clock == js.sim_clock
    for t, j in zip(t_hist, j_hist):
        assert _close(t.mean_loss, j.mean_loss), (t, j)
        # logits agree to ~1e-6 and no argmax of the seeded test set sits
        # that close to a tie, so the evaluations count the same hits
        assert (t.accuracy, t.f1) == (j.accuracy, j.f1)
    assert [e[:3] for e in ts.loss_events] == [e[:3] for e in js.loss_events]
    for t, j in zip(ts.loss_events, js.loss_events):
        assert _close(t[3], j[3]), (t, j)
    assert ts.discarded_updates == js.discarded_updates
    if case["engine"]["mode"] == "event":
        tr, jr = ts.clock_result, js.clock_result
        assert tr.serves == [t_fed.engine.ServeEvent(**dataclasses.asdict(e))
                             for e in jr.serves]
        assert [dataclasses.astuple(c) for c in tr.commits] == \
            [dataclasses.astuple(c) for c in jr.commits]
        assert tr.events == jr.events and tr.dropped == jr.dropped
        assert bool(tr.dropped) == ("deadline" in case["engine"])
    if name == "buffered":
        # two rounds in flight with commits of two uploads: some local
        # updates lose the race to a commit (the case exists for this)
        assert ts.discarded_updates
    if traced:
        t_events, t_other = _chrome_events(tmp_path / "port" / "trace.json")
        j_events, j_other = _chrome_events(tmp_path / "ref" / "trace.json")
        assert t_events == j_events and len(t_events) > 10
        assert t_other == j_other and set(t_other) == {"metrics", "memory", "clock",
                                                        "dropped_spans",
                                                        "dropped_counters"}
        assert t_other["metrics"]["counters"]["stale_discard"] == len(ts.discarded_updates)


def test_obs_plane_only_reads():
    """A port run with every obs sink on follows the same timeline, losses
    and evaluations as the same run with obs off."""
    on = _port(CASES["obs"])
    off = _port({k: v for k, v in CASES["obs"].items() if k != "obs"})
    # equal, a commit with no serve since the last one (mean loss nan) included
    np.testing.assert_equal([dataclasses.astuple(r) for r in on.history],
                            [dataclasses.astuple(r) for r in off.history])
    assert on.loss_events == off.loss_events
    assert on.discarded_updates == off.discarded_updates
    assert off.obs is None and len(on.obs.tracer) > 0


def test_event_sync_equals_analytic_in_the_port():
    """The sync clock replays the analytic round: the same simulated times
    (the engine's degenerate case) and the same losses, dispatch by
    dispatch."""
    case = {"engine": dict(mode="event"), "agg": dict(interval=2)}
    event = _port(case)
    analytic = _port({"engine": dict(mode="analytic"), "agg": dict(interval=2)})
    for e, a in zip(event.history, analytic.history):
        assert abs(e.sim_time_s - a.sim_time_s) <= 1e-12 * a.sim_time_s
        assert e.mean_loss == a.mean_loss
    assert len(event.history) == len(analytic.history) == RUN_KW["rounds"]


# -- the async aggregation functions -----------------------------------------

SIZES = (120, 75, 310, 42)


def _loras(seed):
    rs = np.random.default_rng(seed)
    one = lambda: {"layers": {"attn": {  # noqa: E731
        w: {"a": rs.standard_normal((2, 4, 32)).astype(np.float32),
            "b": rs.standard_normal((2, 32, 4)).astype(np.float32)}
        for w in ("wq", "wv")}}}
    return [one() for _ in SIZES]


def _max_diff(got, want):
    if isinstance(got, dict):
        return max(_max_diff(got[k], want[k]) for k in got)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("staleness,alpha", [((0, 1, 3, 0), 0.5), ((2, 0, 0, 5), 0.0),
                                             ((1, 1, 1, 1), 1.3)])
def test_staleness_weights_match_reference(staleness, alpha):
    pytest.importorskip("jax")
    from repro.core import aggregation as j_agg

    assert t_agg.staleness_weights(SIZES, staleness, alpha) == \
        j_agg.staleness_weights(SIZES, staleness, alpha)
    for s in staleness:
        assert t_agg.staleness_discount(s, alpha) == j_agg.staleness_discount(s, alpha)
        assert t_agg.composed_staleness_discount(s, 2, alpha) == \
            j_agg.composed_staleness_discount(s, 2, alpha)


@pytest.mark.parametrize("anchor", [0.0, 250.0])
def test_merge_into_global_matches_reference(anchor):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import aggregation as j_agg

    glob, *contribs = _loras(3)[:3]
    w = [70.0, 15.5]
    want = j_agg.merge_into_global(jax.tree.map(jnp.asarray, glob),
                                   [jax.tree.map(jnp.asarray, c) for c in contribs], w, anchor)
    got = t_agg.merge_into_global(bridge.to_torch(glob, "cpu"),
                                  [bridge.to_torch(c, "cpu") for c in contribs], w, anchor)
    assert _max_diff(got, want) <= 1e-6


@pytest.mark.parametrize("call", [
    lambda m: m.staleness_discount(-1, 0.5),
    lambda m: m.staleness_discount(1, -0.5),
    lambda m: m.staleness_weights((1, 2), (0,), 0.5),
    lambda m: m.staleness_weights((0, 0), (0, 1), 0.5),
    lambda m: m.composed_staleness_discount(0, -2, 0.5),
    lambda m: m.merge_into_global({}, [], [], 1.0),
    lambda m: m.merge_into_global({}, [{}], [1.0], -1.0),
])
def test_async_aggregation_raises_like_reference(call):
    pytest.importorskip("jax")
    from repro.core import aggregation as j_agg

    msgs = []
    for mod in (j_agg, t_agg):
        with pytest.raises(ValueError) as err:
            call(mod)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
