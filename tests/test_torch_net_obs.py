"""The port's copies of the network plane (``net/links``, ``net/plane``,
``net/topology``, the bundled bandwidth trace), the observability plane
(``obs/tracer``, ``obs/metrics``, ``obs/ledger``, ``obs/des``) and the
federation clock (``fed/engine``) stay bit-equal to their originals: the
same seeded inputs through both give equal numbers, compared with ``==``.
"""
import os

# the JAX reference is imported for its numpy-only modules; keep its JAX,
# should any module pull it in, on the CPU
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import filecmp
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import scheduling as j_sched  # noqa: E402
from repro.fed import devices as j_devices  # noqa: E402
from repro.fed import engine as j_engine  # noqa: E402
from repro import net as j_net  # noqa: E402
from repro.net import topology as j_topo  # noqa: E402
from repro import obs as j_obs  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import scheduling as t_sched  # noqa: E402
from repro_torch.fed import devices as t_devices  # noqa: E402
from repro_torch.fed import engine as t_engine  # noqa: E402
from repro_torch import net as t_net  # noqa: E402
from repro_torch.net import topology as t_topo  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402

PAIRS = ((j_net, j_topo, j_engine, j_obs, j_cost, j_devices, J_REGISTRY, j_sched),
         (t_net, t_topo, t_engine, t_obs, t_cost, t_devices, T_REGISTRY, t_sched))
STARTS = (0.0, 0.0013, 0.25, 0.5, 1.7, 13.0)
SIZES = (0.0, 1.0, 4096.0, 3.2e5, 7.7e6)


def _links(net, kind):
    if kind == "constant":
        return [net.ConstantLink(100.0), net.ConstantLink(37.5)]
    if kind == "trace":
        return [net.TraceLink([0.0, 0.2, 0.9, 1.5], [50.0, 0.0, 7.5, 120.0]),
                net.TraceLink.from_csv(net.bundled_trace_path())]
    # a seed and a non-dyadic dwell (0.37 s has no exact binary form)
    return [net.GilbertElliottLink(100.0, 10.0, p_gb=0.2, p_bg=0.4, dwell_s=0.37, seed=11),
            net.GilbertElliottLink(80.0, 4.0, p_gb=0.5, p_bg=0.3, dwell_s=0.5, seed=7919)]


def _probe(link):
    return ([link.finish_time(t, b) for t in STARTS for b in SIZES],
            [link.rate_bps_at(t) for t in STARTS],
            [link.next_change(t) for t in STARTS],
            link.nominal_mbps, json.dumps(link.state_dict(), sort_keys=True))


@pytest.mark.parametrize("kind", ["constant", "trace", "gilbert"])
def test_link_models_bit_equal(kind):
    for jl, tl in zip(_links(j_net, kind), _links(t_net, kind)):
        assert _probe(jl) == _probe(tl)
        assert [jl.transfer_s(t, 5e5) for t in STARTS] == \
            [tl.transfer_s(t, 5e5) for t in STARTS]


def test_bundled_trace_csv_bit_equal():
    jp, tp = j_net.bundled_trace_path(), t_net.bundled_trace_path()
    assert filecmp.cmp(jp, tp, shallow=False)
    assert j_net.bundled_trace() == t_net.bundled_trace()
    assert j_net.BUNDLED_TRACES == t_net.BUNDLED_TRACES
    jl, tl = j_net.TraceLink.from_csv(jp), t_net.TraceLink.from_csv(tp)
    assert _probe(jl) == _probe(tl)


def _plane(net, shared):
    ups = _links(net, "gilbert") + _links(net, "trace") + _links(net, "constant")
    return net.NetworkPlane(ups, shared=shared, capacity_mbps=90.0 if shared else None)


REQUESTS = [(0, 0.0, 3e5), (1, 0.01, 1e6), (2, 0.01, 2e5), (3, 0.4, 4e5),
            (4, 0.41, 0.0), (5, 1.2, 8e5), (0, 1.3, 5e4)]


@pytest.mark.parametrize("shared", [False, True])
def test_network_plane_and_shared_finish_times_bit_equal(shared):
    out = []
    for net in (j_net, t_net):
        plane = _plane(net, shared)
        res = {"constant": plane.constant_rate, "n": plane.n_clients,
               "nominal": [plane.nominal_mbps(u) for u in range(plane.n_clients)],
               "rates": [list(plane.rates_bps_at(t)) for t in STARTS],
               "predict": [plane.predict_downlink(u, t, b, concurrent=2)
                           for u, t, b in REQUESTS],
               "state": json.dumps(plane.state_dict(), sort_keys=True),
               "shared": net.shared_finish_times(90.0, plane.uplinks, REQUESTS)}
        if not shared:     # a shared plane's transfers go through its cells
            res["up"] = [plane.uplink_finish(u, t, b) for u, t, b in REQUESTS]
            res["down"] = [plane.downlink_finish(u, t, b) for u, t, b in REQUESTS]
        else:
            cell, done = plane.make_cell("down"), []
            for i, (u, t, b) in enumerate(REQUESTS):
                cell.add(t, i, u, b)
                nc = cell.next_completion()
                done.append(nc)
                if nc is not None and nc < t + 0.05:
                    done.append(cell.advance(nc))
            res["cell"] = (done, json.dumps(cell.state_dict(), sort_keys=True, default=str))
        out.append(res)
    assert out[0] == out[1]


@pytest.mark.parametrize("shared", [False, True])
def test_edge_topology_and_commit_legs_bit_equal(shared):
    coords = np.random.default_rng(4).uniform(0, 10, (6, 2))
    out = []
    for net, topo in ((j_net, j_topo), (t_net, t_topo)):
        grouped = topo.EdgeTopology.grouped(6, 3, backhaul_mbps=500.0)
        km = topo.EdgeTopology.kmeans(coords, 2, seed=3, cell_capacity_mbps=60.0)
        plane = _plane(net, shared)
        legs = []
        for tp in (grouped, km):
            for direction in ("up", "down"):
                legs.append(topo.edge_commit_legs(tp, plane, range(6), 0.3,
                                                  lambda u: 1e5 * (u + 1), 4e5, direction))
        out.append((grouped, km, grouped.cell_of(), km.backhaul_s(1e6), legs))
    (jg, jk, *jrest), (tg, tk, *trest) = out
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    assert dataclasses.asdict(jk) == dataclasses.asdict(tk)
    assert jrest == trest


def _times(pair, quantize_ratio=0.26):
    """Eq. 10 terms at bert-base's paper cuts (batch 16, seq 128), the
    links' terms and bytes shrunk as int8 transport shrinks them."""
    cost, devs, reg = pair[4], pair[5], pair[6]
    out = []
    for c, d in zip(devs.PAPER_CUTS, devs.PAPER_CLIENTS):
        st = cost.client_step_times(reg["bert-base"], c, d, devs.SERVER, devs.LINK, 16, 128)
        out.append(dataclasses.replace(st, t_fc=st.t_fc * quantize_ratio,
                                       t_bc=st.t_bc * quantize_ratio,
                                       fc_bytes=st.fc_bytes * quantize_ratio,
                                       bc_bytes=st.bc_bytes * quantize_ratio))
    return out


def _result(res):
    return (res.round_time, [dataclasses.astuple(s) for s in res.service], res.completion,
            res.waits, res.dropped, res.events, res.order)


@pytest.mark.parametrize("policy", ["fifo", "wf", "priority", "bw", "order"])
@pytest.mark.parametrize("slots,chunk,deadline,network", [
    (1, 1, None, None), (2, 1, None, "gilbert"), (1, 3, None, "shared"),
    (2, 2, 0.9, None), (1, 1, 1.4, "shared")])
def test_simulate_round_bit_equal(policy, slots, chunk, deadline, network):
    out = []
    for pair in PAIRS:
        net, engine = pair[0], pair[2]
        times = _times(pair)
        pri = [0.5, 0.25, 1.0, 0.75, 0.125, 2.0]
        jobs = engine.jobs_from_times(times, range(6), priorities=pri,
                                      arrivals=[0.0, 0.05, 0.0, 0.3, 0.1, 0.0])
        plane = None
        if network is not None:
            plane = net.NetworkPlane(_links(net, "gilbert") * 3,
                                     shared=network == "shared",
                                     capacity_mbps=120.0 if network == "shared" else None)
        kw = dict(order=[2, 0, 5, 1, 4, 3]) if policy == "order" else dict(policy=policy)
        res = engine.simulate_round(jobs, slots=slots, cohort_chunk=chunk,
                                    chunk_efficiency=0.8 if chunk > 1 else 1.0,
                                    deadline=deadline, network=plane, t_origin=0.2, **kw)
        out.append(_result(res))
    assert out[0] == out[1]
    if deadline is None:
        assert not out[0][4]


def _clock(pair, agg_policy, inflight, obs=False, rounds=3):
    net, engine, obs_mod, cost, devs, reg = pair[0], pair[2], pair[3], pair[4], pair[5], pair[6]
    times = _times(pair)
    plane = net.NetworkPlane(_links(net, "gilbert") * 3, shared=True, capacity_mbps=150.0)
    cfg = engine.ClockConfig(policy="priority", cohort_chunk=3, agg_policy=agg_policy,
                             agg_interval=2 if agg_policy == "sync" else 1,
                             buffer_k=3 if agg_policy == "buffered" else 1,
                             max_inflight_rounds=inflight)
    bundle = None
    if obs:
        bundle = obs_mod.Observability(
            tracer=obs_mod.Tracer(), metrics=obs_mod.MetricsRegistry(),
            ledger=obs_mod.MemoryLedger.from_model(reg["bert-base"], devs.PAPER_CUTS, 16, 128))
    clock = engine.FederationClock(
        6, rounds, cfg, times_fn=lambda u, r: times[u],
        priorities=[0.5, 0.25, 1.0, 0.75, 0.125, 2.0], network=plane,
        agg_bytes_fn=lambda u: cost.lora_upload_bytes(reg["bert-base"], devs.PAPER_CUTS[u]),
        obs=bundle)
    calls = []
    if agg_policy == "sync":
        def plan(rnd):
            calls.append(("plan", rnd))
            return engine.RoundPlan(jobs=engine.jobs_from_times(times, range(6)),
                                    policy="fifo")
        res = clock.run(plan_fn=plan, on_serve=lambda ev: calls.append(("serve", ev.uids)),
                        on_commit=lambda ev: calls.append(("commit", ev.version)) or 0.01,
                        on_round_end=lambda rnd, r: calls.append(("end", rnd)))
    else:
        res = clock.run(on_serve=lambda ev: calls.append(("serve", ev.uids, ev.rounds)),
                        on_commit=lambda ev: calls.append(("commit", ev.staleness)) or {},
                        on_round_start=lambda u, r, t: calls.append(("start", u, r, t)))
    state = json.dumps(clock.state_dict(), sort_keys=True, default=str)
    return res, calls, state, bundle


def _clock_result(res):
    return (res.makespan, [dataclasses.astuple(s) for s in res.serves],
            [dataclasses.astuple(c) for c in res.commits], res.rounds_completed,
            res.dropped, [_result(r) for r in res.round_results], res.events, res.preempted)


@pytest.mark.parametrize("agg_policy,inflight", [("sync", 1), ("buffered", 2),
                                                 ("staleness", 2)])
def test_federation_clock_bit_equal(agg_policy, inflight):
    (jres, jcalls, jstate, _), (tres, tcalls, tstate, _) = (
        _clock(pair, agg_policy, inflight) for pair in PAIRS)
    assert _clock_result(jres) == _clock_result(tres)
    assert jcalls == tcalls and jstate == tstate
    assert jres.commits and jres.serves


@pytest.mark.parametrize("agg_policy,inflight", [("sync", 1), ("buffered", 2)])
def test_tracer_metrics_and_ledger_bit_equal(agg_policy, inflight):
    (*_, jobs), (*_, tobs) = (_clock(pair, agg_policy, inflight, obs=True) for pair in PAIRS)
    assert json.dumps(jobs.tracer.to_chrome({"k": 1})) == \
        json.dumps(tobs.tracer.to_chrome({"k": 1}))
    assert len(jobs.tracer) == len(tobs.tracer) > 0
    for key, arr in jobs.tracer.to_arrays().items():
        np.testing.assert_array_equal(tobs.tracer.to_arrays()[key], arr)
    assert jobs.metrics.summary() == tobs.metrics.summary()
    assert jobs.metrics.to_json() == tobs.metrics.to_json()
    for name in ("client_base", "client_act", "server_act"):
        np.testing.assert_array_equal(getattr(tobs.ledger, name), getattr(jobs.ledger, name))
    assert (tobs.ledger.server_base, tobs.ledger.local_baseline) == \
        (jobs.ledger.server_base, jobs.ledger.local_baseline)
    assert tobs.ledger.report() == jobs.ledger.report()
    for track in (-1, 0, 5):
        for a, b in zip(jobs.ledger.curve(track), tobs.ledger.curve(track)):
            np.testing.assert_array_equal(b, a)
    assert json.dumps(jobs.state_dict(), sort_keys=True, default=str) == \
        json.dumps(tobs.state_dict(), sort_keys=True, default=str)


@pytest.mark.parametrize("cuts", [(1, 2, 3, 4, 5, 6), (0, 6, 11, 11, 3, 3)])
def test_memory_ledger_from_model_bit_equal(cuts):
    j = j_obs.MemoryLedger.from_model(J_REGISTRY["bert-base"], cuts, 16, 128)
    t = t_obs.MemoryLedger.from_model(T_REGISTRY["bert-base"], cuts, 16, 128)
    for name in ("client_base", "client_act", "server_act"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.server_base, t.local_baseline) == (j.server_base, j.local_baseline)
    j.set_cut(2, 7)
    t.set_cut(2, 7)
    np.testing.assert_array_equal(t.client_base, j.client_base)


def test_record_commit_and_sync_wave_bit_equal():
    out = []
    for pair in PAIRS:
        engine, obs = pair[2], pair[3]
        bundle = obs.Observability(tracer=obs.Tracer(max_events=50),
                                   metrics=obs.MetricsRegistry(),
                                   ledger=obs.MemoryLedger([1.0] * 6, [2.0] * 6, [3.0] * 6, 10.0))
        jobs = engine.jobs_from_times(_times(pair), range(6))
        res = engine.simulate_round(jobs, policy="wf", deadline=0.8)
        obs.record_sync_wave(bundle, res, jobs, 4.5, 3)
        for ev in (engine.CommitEvent(time=5.0, version=1, contributors=(0, 2),
                                      staleness=(0, 1), overhead=0.25),
                   engine.CommitEvent(time=6.0, version=2, contributors=(1,),
                                      staleness=(3,), forced=True)):
            obs.record_commit(bundle, ev)
        out.append((json.dumps(bundle.tracer.to_chrome()), bundle.tracer.dropped_spans,
                    bundle.metrics.summary(), bundle.ledger.report()))
    assert out[0] == out[1]
    assert out[0][2]["counters"]["commits"] == 2.0


@pytest.mark.parametrize("scheduler", ["ours", "fifo", "wf", "bw"])
def test_sync_wave_is_the_closed_form_over_its_own_order(scheduler):
    """At bert-base's paper cuts, a sync wave served by the online form of
    a scheduler takes exactly ``cost_model.makespan`` over the order it
    served, in both packages; that order may differ from the analytic
    engine's fixed order (Alg. 2's: the online form serves the arrived
    client of highest priority instead of idling for the next in line)."""
    out = []
    for pair in PAIRS:
        engine, cost, devs, reg, sched = pair[2], pair[4], pair[5], pair[6], pair[7]
        times = [cost.client_step_times(reg["bert-base"], c, d, devs.SERVER, devs.LINK, 16, 128)
                 for c, d in zip(devs.PAPER_CUTS, devs.PAPER_CLIENTS)]
        tfl = [d.tflops for d in devs.PAPER_CLIENTS]
        policy, needs_pri = sched.ONLINE_DISCIPLINES[scheduler]
        pri = sched.alg2_priorities(list(devs.PAPER_CUTS), tfl) if needs_pri else None
        res = engine.simulate_round(engine.jobs_from_times(times, range(6), priorities=pri),
                                    policy=policy)
        fixed = sched.resolve_order(scheduler, times, list(devs.PAPER_CUTS), tfl)
        assert res.round_time == cost.makespan(times, res.order)[0]
        out.append((res.order, res.round_time, fixed, cost.makespan(times, fixed)[0]))
    assert out[0] == out[1]
    if scheduler == "ours":
        assert out[0][0] != out[0][2] and out[0][1] > out[0][3]
