"""The control plane in the port against the JAX package's.

``repro_torch.control`` copies ``repro.control`` (telemetry, controllers,
the live solver, the control loop): each copy is held bit for bit against
its original on seeded inputs, and the loop drives the port's
``FederationClock`` through ``times_fn``, ``on_serve`` and ``on_commit`` in
the reference's own fade and memory-shed settings with event lists, commit
times, decisions and final cuts equal.

Then both Simulators, from the reference's initial state
(``bridge.load_reference_state``), at reduced(bert-base, 3 layers, d 128)
with four clients at cut 2 (at 2 layers no cut can move: the loop's
``min_cut`` 1 is its ``max_cut``): sync reactive with a forced memory shed,
buffered reactive on a fading custom link under nominal and plane
transport (the latter with every obs sink on), periodic under scheduler
"ours" with two rounds in flight, and a buffered memory shed with uploads
queued at a loaded server, where the clock's online priorities must follow
the migrated cut.  Every case applies at least one cut
change; decisions, simulated times, loss-event keys, discarded updates and
the Chrome trace are equal exactly, the losses within 1e-4 relative.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

pytest.importorskip("jax")

import repro.configs  # noqa: E402
import repro.control  # noqa: E402
import repro.core.cost_model  # noqa: E402
import repro.data  # noqa: E402
import repro.fed  # noqa: E402
import repro.fed.devices  # noqa: E402
import repro.fed.engine  # noqa: E402
import repro.net  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.control  # noqa: E402
import repro_torch.core.cost_model  # noqa: E402
import repro_torch.data  # noqa: E402
import repro_torch.fed  # noqa: E402
import repro_torch.fed.devices  # noqa: E402
import repro_torch.fed.engine  # noqa: E402
import repro_torch.net  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()


def _pkg(root):
    return SimpleNamespace(configs=root.configs, control=root.control,
                           cost=root.core.cost_model, fed=root.fed,
                           devices=root.fed.devices, engine=root.fed.engine,
                           net=root.net)


J, T = _pkg(repro), _pkg(repro_torch)
RATE = 100.0


def _both(fn):
    """``fn`` on the reference's modules and on the port's."""
    return fn(J), fn(T)


def _loaded_server(m, factor=8):
    return dataclasses.replace(m.devices.SERVER,
                               utilization=m.devices.SERVER.utilization / factor)


# -- the copies, bit for bit ----------------------------------------------------

def _links(m, seed):
    return [m.net.TraceLink([0.0, 0.7, 1.9], [RATE, 12.0, 60.0]),
            m.net.GilbertElliottLink(80.0, 8.0, p_gb=0.3, p_bg=0.5, dwell_s=0.2, seed=seed),
            *[m.net.ConstantLink(r) for r in (RATE, 50.0, 25.0, 70.0)]]


@pytest.mark.parametrize("alpha,seed", [(1.0, 0), (0.5, 1), (0.3, 2)])
def test_telemetry_store_bit_equal(alpha, seed):
    """EWMAs from plane samples, realized transfers and serve spans; memory
    headroom before and after a pressure event; snapshots; state_dict."""
    def trace(m):
        cfg = m.configs.REGISTRY["bert-base"]
        devs = m.devices.PAPER_CLIENTS
        plane = m.net.NetworkPlane(_links(m, seed))
        store = m.control.TelemetryStore(
            cfg, 6, [plane.nominal_mbps(u) for u in range(6)],
            [d.mem_gb * 2 ** 30 * 0.5 for d in devs], alpha=alpha)
        rs = np.random.default_rng(seed)
        out = []
        for step in range(12):
            store.sample_plane(plane, 0.37 * step, uids=None if step % 2 else [0, 1, 4])
            store.observe_step(int(rs.integers(6)), float(rs.uniform(0.01, 2.0)))
            store.observe_transfer(int(rs.integers(6)), float(rs.uniform(1e5, 1e7)),
                                   float(rs.uniform(0.0, 1.0)) if step != 3 else 0.0)
            store.observe_rate(int(rs.integers(6)), float(rs.uniform(1.0, 150.0)))
            if step == 5:
                store.set_mem_budget(2, 1e6)
            cuts = [int(c) for c in rs.integers(1, 12, size=6)]
            out.append(store.state_dict())
            out.append([store.mem_headroom(u, cuts[u], 16, 128) for u in range(6)])
            out.append([dataclasses.astuple(store.snapshot(u, cuts[u], 16, 128,
                                                           plane.nominal_mbps(u)))
                        for u in range(6)])
        return out

    want, got = _both(trace)
    np.testing.assert_equal(got, want)      # NaN (an unobserved step span) equal to NaN


def _samples(m, rs, n=6):
    return [m.control.ClientSample(uid=u, rate_mbps=float(rs.uniform(40.0, 160.0)),
                                   nominal_mbps=RATE, step_s=float(rs.uniform(0.1, 1.0)),
                                   mem_headroom_bytes=float(rs.uniform(-1e8, 1e9)))
            for u in range(n)]


@pytest.mark.parametrize("name,kw", [("static", {}), ("periodic", {"resolve_every": 1}),
                                     ("periodic", {"resolve_every": 3}),
                                     ("reactive", {"hysteresis": 0.1}),
                                     ("reactive", {})])
def test_controllers_bit_equal(name, kw):
    """should_resolve's triggers and the state_dict after each boundary, on
    seeded samples drifting across the bands (headroom sometimes negative)."""
    def trace(m):
        ctl = m.control.make_controller(name, **kw)
        rs = np.random.default_rng(11)
        out = []
        for step in range(20):
            samples = _samples(m, rs)
            trig = ctl.should_resolve(0.5 * step, step, samples)
            if trig is not None:
                ctl.on_resolved(0.5 * step, samples, trig.uids or range(6))
            out.append((None if trig is None else dataclasses.astuple(trig),
                        ctl.state_dict()))
        return out

    want, got = _both(trace)
    assert got == want
    assert any(trig is not None for trig, _ in got) == (name != "static")


SOLVER_CASES = {
    "loaded": dict(cuts=[3] * 6, rates=[RATE, RATE, 5.0, RATE, 40.0, RATE], kw={}),
    "paper_cuts_fifo": dict(cuts=[1, 1, 2, 2, 3, 3], rates=[4.0, 60.0, RATE, 20.0, RATE, 8.0],
                            kw={"scheduler": "fifo", "max_cut": 6}),
    "memory_repair": dict(cuts=[5, 4, 3, 3, 2, 6], rates=[RATE] * 6,
                          kw={"mem_budget_bytes": [0.0, 1e18, 3e8, 1e18, 1e18, 5e8],
                              "adjustable": [0, 2, 5]}),
    "rank_and_batch": dict(cuts=[3] * 6, rates=[RATE, 3.0, RATE, RATE, 10.0, RATE],
                           kw={"rank_candidates": (4, 8, 32), "batch_candidates": (8, 32),
                               "min_cut": 2}),
}


@pytest.mark.parametrize("name", list(SOLVER_CASES))
def test_solver_bit_equal(name):
    """solve_assignment (the memory repair, coordinate descent, rank and
    batch candidates), predicted_span and predicted_times."""
    case = SOLVER_CASES[name]

    def solve(m):
        cfg = m.configs.REGISTRY["bert-base"]
        devs, srv = m.devices.PAPER_CLIENTS, _loaded_server(m)
        base = m.control.Assignment.uniform(case["cuts"], cfg.lora.rank, 16)
        asg, span = m.control.solve_assignment(cfg, devs, srv, case["rates"], base, 128,
                                               **case["kw"])
        spans = [m.control.predicted_span(cfg, devs, srv, case["rates"], a, 128,
                                          scheduler=sched, ref_samples=ref)
                 for a in (base, asg) for sched in ("ours", "fifo") for ref in (None, 96.0)]
        times = [dataclasses.astuple(st) for st in
                 m.control.predicted_times(cfg, devs, srv, case["rates"], asg, 128)]
        return dataclasses.astuple(asg), span, spans, times

    want, got = _both(solve)
    assert got == want
    if name == "memory_repair":
        assert got[0][0][0] == 1          # nothing fits: shed to min_cut
    if name == "rank_and_batch":
        assert got[0] != dataclasses.astuple(
            T.control.Assignment.uniform([3] * 6, 16, 16))


@pytest.mark.parametrize("old,new", [(3, 5), (5, 3), (1, 11), (11, 1), (4, 4)])
@pytest.mark.parametrize("rank", [None, 4])
def test_migration_bytes_bit_equal(old, new, rank):
    """Growing ships frozen weights and adapters down, shrinking adapters up."""
    want, got = _both(lambda m: m.cost.migration_bytes(m.configs.REGISTRY["bert-base"],
                                                       old, new, 4, rank=rank))
    assert got == want
    down, up = got
    assert (down > 0) == (new > old) and (up > 0) == (new < old)


# -- pure DES: the loop drives the clock ----------------------------------------

def _des(m, controller, shed=None, clock_kw=None, **kw):
    """The reference's deterministic fade: client 0's link collapses 100 ->
    4 Mbps at t = 5 and stays there; four Jetson Nanos at cut 3 against a
    loaded server.  ``shed`` takes one client's memory budget away first."""
    nano = m.devices.JETSON_NANO
    plane = m.net.NetworkPlane([m.net.TraceLink([0.0, 5.0], [RATE, 4.0])]
                               + [m.net.ConstantLink(RATE)] * 3)
    loop = m.control.ControlLoop(m.configs.REGISTRY["bert-base"], [nano] * 4,
                                 _loaded_server(m), plane, [3] * 4, batch=16, seq_len=128,
                                 controller=controller, ewma_alpha=1.0, **kw)
    if shed is not None:
        loop.telemetry.set_mem_budget(shed, 1.0)
    ccfg = m.engine.ClockConfig(**(clock_kw or dict(policy="priority", agg_policy="buffered",
                                                    buffer_k=2, max_inflight_rounds=1)))
    clk = m.engine.FederationClock(4, 6, ccfg, times_fn=loop.times_fn, priorities=loop.pri,
                                   network=plane)
    res = clk.run(on_commit=loop.on_commit, on_serve=loop.on_serve)
    return {"events": res.events, "makespan": res.makespan,
            "serves": [dataclasses.astuple(e) for e in res.serves],
            "commits": [dataclasses.astuple(c) for c in res.commits],
            "decisions": [dataclasses.asdict(d) for d in loop.decisions],
            "cuts": list(loop.cuts), "pri": list(loop.pri), "state": loop.state_dict()}


DES_CASES = {
    "fade_reactive": dict(controller="reactive", hysteresis=0.25),
    "fade_static": dict(controller="static"),
    "fade_periodic": dict(controller="periodic", resolve_every=2),
    "memory_shed": dict(controller="reactive", shed=2),
    "memory_shed_two_inflight": dict(controller="reactive", shed=1, clock_kw=dict(
        policy="fifo", agg_policy="buffered", buffer_k=3, max_inflight_rounds=2)),
}


@pytest.mark.parametrize("name", list(DES_CASES))
def test_control_loop_drives_the_clock_like_reference(name):
    want, got = _both(lambda m: _des(m, **DES_CASES[name]))
    assert got == want
    applied = [d for d in got["decisions"] if d["applied"]]
    if name == "fade_reactive":
        # the faded client shed layers; nobody else churned
        assert applied and all(list(d["cut_changes"]) == [0] for d in applied)
        assert got["cuts"][0] < 3 and got["cuts"][1:] == [3, 3, 3]
    if name == "fade_static":
        assert got["decisions"] == [] and got["cuts"] == [3] * 4
    if name.startswith("memory_shed"):
        shed = DES_CASES[name]["shed"]
        assert applied[0]["trigger"] == "memory" and got["cuts"][shed] == 1


def test_memory_pressure_decision_like_reference():
    """One decide() at a commit boundary under a memory-pressure event."""
    def decide(m):
        plane = m.net.NetworkPlane([m.net.ConstantLink(RATE)] * 4)
        loop = m.control.ControlLoop(m.configs.REGISTRY["bert-base"],
                                     [m.devices.JETSON_NANO] * 4, m.devices.SERVER, plane,
                                     [3] * 4, batch=16, seq_len=128, controller="reactive",
                                     ewma_alpha=1.0)
        loop.telemetry.set_mem_budget(2, 1.0)
        out = loop.decide(1.0, [0, 1, 2, 3], 1)
        return out, list(loop.cuts), dataclasses.asdict(loop.decisions[-1])

    want, got = _both(decide)
    assert got == want
    assert got[0][0] == {2: (3, 1)} and got[1] == [3, 3, 1, 3]


# -- Simulator parity ---------------------------------------------------------

N_CLIENTS = 4
CUTS = (2,) * N_CLIENTS
RUN_KW = dict(rounds=3, batch_size=4, seq_len=16, lr=1e-3)
# the port's Simulator parity tolerance (tests/test_torch_event.py): a mean
# loss after AdamW steps, far inside any step-1 flip (ROADMAP Queue C)
LOSS_RTOL = 1e-4
# the devices at a tenth of the paper's rates: at this reduced width a
# layer's client compute is then worth more than a one-layer adapter
# migration over the faded link, so the fade's migration is accepted
SLOWDOWN = 10.0
SHED_CLIENT = 1

_FADE = {"net": dict(link_model="custom"), "links": True,
         "control": dict(policy="reactive", hysteresis=0.25)}


def _buffered(**kw):
    return {"engine": dict(mode="event"),
            "agg": dict(policy="buffered", interval=1, max_inflight=1, **kw)}


CASES = {
    # client 1's memory budget is taken away before the run: the first
    # commit sheds its layers whatever the predicted gain
    "sync_memory_shed": {"engine": dict(mode="event"), "agg": dict(interval=1),
                         "control": dict(policy="reactive"), "shed": SHED_CLIENT},
    "buffered_fade_nominal": {**_buffered(), **_FADE},
    "buffered_fade_plane_obs": {**_buffered(transport="plane"), **_FADE,
                                "obs": dict(trace=True, metrics=True, memory_ledger=True)},
    "periodic_ours_async": {"engine": dict(mode="event", scheduler="ours"),
                            "agg": dict(policy="buffered", interval=1, max_inflight=2),
                            "control": dict(policy="periodic", resolve_every=2)},
    # a server a thousand times slower, so uploads queue and Alg. 2's
    # online priority orders them: after client 1 sheds a layer its live
    # N_c/C places it behind client 2, where its pre-migration ratio would
    # not (a clock left on stale priorities serves another order)
    "buffered_memory_shed_queued": {**_buffered(), "engine": dict(mode="event", scheduler="ours"),
                                    "control": dict(policy="reactive"), "shed": SHED_CLIENT,
                                    "server_load": 1000.0},
}


def _datasets(make):
    return (make(400, seq_len=16, vocab_size=4096, seed=0),
            make(80, seq_len=16, vocab_size=4096, seed=1))


def _run_config(fed, case, trace_dir=None):
    groups = {"engine": fed.EngineConfig, "agg": fed.AggConfig, "net": fed.NetConfig,
              "control": fed.ControlConfig, "obs": fed.ObsConfig}
    kw = dict(RUN_KW)
    for name, cls in groups.items():
        if name in case:
            args = dict(case[name])
            if name == "obs" and trace_dir is not None:
                args["trace_dir"] = str(trace_dir)
            kw[name] = cls(**args)
    return fed.FedRunConfig(**kw)


def _simulator(m, case, trace_dir=None, **kw):
    cfg = m.configs.reduced(m.configs.REGISTRY["bert-base"], n_layers=3,
                            d_model=128).with_(vocab_size=4096)
    devs = [dataclasses.replace(d, tflops=d.tflops / SLOWDOWN)
            for d in m.fed.PAPER_CLIENTS[:N_CLIENTS]]
    links = None
    if case.get("links"):
        links = [m.net.TraceLink([0.0, 0.001], [RATE, 4.0])] + \
            [m.net.ConstantLink(RATE)] * (N_CLIENTS - 1)
    server = m.devices.SERVER
    if "server_load" in case:
        server = dataclasses.replace(server, utilization=server.utilization / case["server_load"])
    make = (repro if m is J else repro_torch).data.make_emotion_dataset
    sim = m.fed.Simulator(cfg, devs, CUTS, *_datasets(make),
                          _run_config(m.fed, case, trace_dir), links=links, server=server,
                          **kw)
    if "shed" in case:
        sim._control.telemetry.set_mem_budget(case["shed"], 1.0)
    return sim


def _reference(case, trace_dir=None):
    import jax

    js = _simulator(J, case, trace_dir)
    state = {k: jax.tree.map(np.asarray, getattr(js, k)) for k in bridge.STATE_KEYS}
    js.run_training()
    return js, state


def _port(case, state=None, trace_dir=None):
    ts = _simulator(T, case, trace_dir, device="cpu")
    if state is not None:
        bridge.load_reference_state(ts, state)
    ts.run_training()
    return ts


def _close(got: float, want: float) -> bool:
    if math.isnan(want):
        return math.isnan(got)
    return abs(got - want) <= LOSS_RTOL * abs(want)


def _chrome_events(path):
    with open(path) as f:
        doc = json.load(f)
    return [(e.get("name"), e.get("ph"), e.get("pid"), e.get("tid"), e.get("ts"),
             e.get("dur")) for e in doc["traceEvents"]], doc.get("otherData", {})


def _leading_dim(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


@pytest.mark.parametrize("name", list(CASES))
def test_controlled_simulator_matches_reference(name, tmp_path):
    case = CASES[name]
    traced = "obs" in case
    js, state = _reference(case, tmp_path / "ref" if traced else None)
    ts = _port(case, state, tmp_path / "port" if traced else None)

    assert any(ev.applied and ev.cut_changes for ev in ts.control_events)
    assert [dataclasses.asdict(e) for e in ts.control_events] == \
        [dataclasses.asdict(e) for e in js.control_events]
    assert ts.cuts == js.cuts and ts.cuts != list(CUTS)
    if "shed" in case:
        assert ts.control_events[0].trigger == "memory" and ts.cuts[case["shed"]] == 1
    # the migrated clients' frozen prefixes and steps follow the live cuts
    for u in range(N_CLIENTS):
        assert _leading_dim(ts.client_params[u]["layers"]) == ts.cuts[u]
        assert ts.cuts[u] in ts._cli_steps and ts.cuts[u] in ts._srv_steps

    j_hist, t_hist = js.history, ts.history
    assert [r.round for r in t_hist] == [r.round for r in j_hist] and t_hist
    assert [r.sim_time_s for r in t_hist] == [r.sim_time_s for r in j_hist]
    assert ts.sim_clock == js.sim_clock
    for t, j in zip(t_hist, j_hist):
        assert _close(t.mean_loss, j.mean_loss), (t, j)
        assert (t.accuracy, t.f1) == (j.accuracy, j.f1)
    assert [e[:3] for e in ts.loss_events] == [e[:3] for e in js.loss_events]
    for t, j in zip(ts.loss_events, js.loss_events):
        assert _close(t[3], j[3]), (t, j)
    assert ts.discarded_updates == js.discarded_updates
    tr, jr = ts.clock_result, js.clock_result
    assert [dataclasses.astuple(e) for e in tr.serves] == \
        [dataclasses.astuple(e) for e in jr.serves]
    assert [dataclasses.astuple(c) for c in tr.commits] == \
        [dataclasses.astuple(c) for c in jr.commits]
    assert tr.events == jr.events
    if traced:
        t_events, t_other = _chrome_events(tmp_path / "port" / "trace.json")
        j_events, j_other = _chrome_events(tmp_path / "ref" / "trace.json")
        assert t_events == j_events
        assert t_other == j_other
        n_reassign = sum(e[0] == "reassign" for e in t_events)
        assert n_reassign == len(ts.control_events) > 0
        counters = t_other["metrics"]["counters"]
        assert counters.get("migration_accepted", 0) + \
            counters.get("migration_rejected", 0) == n_reassign


def test_static_control_attaches_nothing():
    """controller='static' is the uncontrolled run: no loop, no events, and
    the same history and loss events as a run without a ControlConfig."""
    case = {**_buffered(), "net": dict(link_model="custom"), "links": True}
    plain = _port(case)
    static = _port({**case, "control": dict(policy="static")})
    assert static._control is None and static.control_events == []
    np.testing.assert_equal([dataclasses.astuple(r) for r in static.history],
                            [dataclasses.astuple(r) for r in plain.history])
    assert static.loss_events == plain.loss_events
    assert static.cuts == plain.cuts == list(CUTS)


# -- the card's control phase, predicted on the CPU ------------------------------

def test_chip_smoke_control_prediction_is_pinned():
    """``chip_smoke.py --predict-control`` replays the [control] phase's two
    runs on the CPU at bert-base's full-width timing.  Its last output, the
    ``PREDICTED_CONTROL`` literal, is the text the script holds the card's
    runs to, and the sync run's launches at the migrated cuts differ from
    the rule at the initial cuts, so the card's counters see the migration."""
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script), "--predict-control"],
                          env=dict(os.environ, OMP_NUM_THREADS="4"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    printed = out[out.index("PREDICTED_CONTROL = "):].rstrip("\n")
    source = script.read_text()
    start = source.index("PREDICTED_CONTROL = {")
    assert source[start:source.index("\n\n\n", start)] == printed
    runs = {line.split("] ", 1)[0][len("[predict:"):]: json.loads(line.split("] ", 1)[1])
            for line in out.splitlines() if line.startswith("[predict:")}
    assert sorted(runs) == ["buffered", "sync"]
    for run in runs.values():
        assert any(d["applied"] and d["cut"] for d in run["decisions"])
        assert run["reassign_spans"] == len(run["decisions"])
    assert runs["sync"]["launches"] != runs["sync"]["launches_at_initial_cuts"]
