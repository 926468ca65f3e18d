"""The port's copies of the JAX package's numpy-only modules (the eleven
configs, ``reduced`` and the input shapes, data,
cost model, scheduling, devices with ``make_fleet`` and ``make_link_fleet``, metrics, run
config, the wire-byte count of the transport compression, capacity-based
partitioning, and the population scale: ``FleetSpec``, cohort sampling, the
vectorized round, the ``PopulationClock`` without a trainer and the SoA
async kernel) stay bit-equal to their originals on seeded inputs.  The copies of the network plane
(``net/links``, ``net/plane``, ``net/topology``, the bundled trace), the
observability plane (``obs/tracer``, ``obs/metrics``, ``obs/ledger``,
``obs/des``) and the federation clock (``fed/engine``) are pinned in
tests/test_torch_net_obs.py; those of the control plane
(``control/telemetry``, ``control/controller``, ``control/solver``,
``control/loop`` and ``control/__init__``) in tests/test_torch_control.py."""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import configs as j_configs  # noqa: E402
from repro.comm import transport_bytes as j_transport_bytes  # noqa: E402
from repro import data as j_data  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import partition as j_part  # noqa: E402
from repro.core import scheduling as j_sched  # noqa: E402
from repro.fed import config as j_fedcfg  # noqa: E402
from repro.fed import devices as j_devices  # noqa: E402
from repro.fed import metrics as j_metrics  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.comm import transport_bytes as t_transport_bytes  # noqa: E402
from repro_torch import data as t_data  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import partition as t_part  # noqa: E402
from repro_torch.core import scheduling as t_sched  # noqa: E402
from repro_torch.fed import config as t_fedcfg  # noqa: E402
from repro_torch.fed import devices as t_devices  # noqa: E402
from repro_torch.fed import metrics as t_metrics  # noqa: E402


def _same_config(a, b):
    """The port's config ``b`` equals the reference's ``a`` field for field;
    the fields only the port's ``ModelConfig`` has (the per-layer hybrid's
    ``layer_types`` and Granite's multipliers) sit at their defaults, at
    which they add no operation."""
    want, got = dataclasses.asdict(a), dataclasses.asdict(b)
    extra = {f.name: f.default for f in dataclasses.fields(b) if f.name not in want}
    assert {k: got.pop(k) for k in extra} == extra
    assert want == got


@pytest.mark.parametrize("kw", [{}, {"n_layers": 2, "d_model": 128},
                                {"n_layers": 4, "d_model": 256, "seq_cap": 64}])
def test_bert_config_and_reduced(kw):
    j, t = j_configs.REGISTRY["bert-base"], t_configs.REGISTRY["bert-base"]
    _same_config(j, t)
    if kw:
        _same_config(j_configs.reduced(j, **kw), t_configs.reduced(t, **kw))
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-3b"])
@pytest.mark.parametrize("kw", [{}, {"n_layers": 2, "d_model": 256},
                                {"n_layers": 3, "d_model": 128, "seq_cap": 64}])
def test_decoder_lm_configs_and_reduced(arch, kw):
    j, t = j_configs.REGISTRY[arch], t_configs.REGISTRY[arch]
    _same_config(j, t)
    if kw:
        _same_config(j_configs.reduced(j, **kw), t_configs.reduced(t, **kw))
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-20b", "qwen1.5-4b",
                                  "qwen3-moe-30b-a3b", "grok-1-314b", "internvl2-26b",
                                  "zamba2-7b", "whisper-large-v3"])
@pytest.mark.parametrize("kw", [{}, {"n_layers": 2, "d_model": 256},
                                {"n_layers": 3, "d_model": 128, "seq_cap": 64}])
def test_other_configs_and_reduced(arch, kw):
    j, t = j_configs.REGISTRY[arch], t_configs.REGISTRY[arch]
    _same_config(j, t)
    if kw:
        _same_config(j_configs.reduced(j, **kw), t_configs.reduced(t, **kw))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_registry_and_shapes_match():
    # the port's registry is the reference's, then the port's own configs
    assert list(t_configs.REGISTRY) == list(j_configs.REGISTRY) + list(t_configs.PORT_ARCHS)
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert t_configs.ASSIGNED_SHAPES == j_configs.ASSIGNED_SHAPES
    assert list(t_configs.SHAPES) == list(j_configs.SHAPES)
    for name, shape in j_configs.SHAPES.items():
        got = t_configs.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(shape)
        assert got.step_name == shape.step_name
    with pytest.raises(KeyError, match="unknown input shape"):
        t_configs.get_shape("train_1k")


@pytest.mark.parametrize("seed", [0, 3])
def test_emotion_dataset_partition_and_loader(seed):
    jd = j_data.make_emotion_dataset(500, seq_len=24, vocab_size=4096, seed=seed)
    td = t_data.make_emotion_dataset(500, seq_len=24, vocab_size=4096, seed=seed)
    np.testing.assert_array_equal(jd.tokens, td.tokens)
    np.testing.assert_array_equal(jd.labels, td.labels)
    jp = j_data.dirichlet_partition(jd.labels, 6, 0.5, seed)
    tp = t_data.dirichlet_partition(td.labels, 6, 0.5, seed)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    jl = j_data.ClassificationLoader(jd.subset(jp[0]), 4, seed=seed + 1)
    tl = t_data.ClassificationLoader(td.subset(tp[0]), 4, seed=seed + 1)
    for _ in range(2 * len(jl) + 3):           # crosses epoch boundaries
        jb, tb = jl.next_batch(), tl.next_batch()
        for key in ("tokens", "label"):
            np.testing.assert_array_equal(jb[key], tb[key])
    for jb, tb in zip(jl.all_batches(), tl.all_batches()):
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])


def _times(mod, devs, cfg, cuts, server, link):
    return [mod.client_step_times(cfg, c, d, server, link, 16, 128)
            for c, d in zip(cuts, devs)]


def test_cost_model_and_alg2_order_bit_equal():
    jcfg, tcfg = j_configs.REGISTRY["bert-base"], t_configs.REGISTRY["bert-base"]
    jt = _times(j_cost, j_devices.PAPER_CLIENTS, jcfg, j_devices.PAPER_CUTS,
                j_devices.SERVER, j_devices.LINK)
    tt = _times(t_cost, t_devices.PAPER_CLIENTS, tcfg, t_devices.PAPER_CUTS,
                t_devices.SERVER, t_devices.LINK)
    assert [dataclasses.asdict(x) for x in jt] == [dataclasses.asdict(x) for x in tt]
    tfl = [d.tflops for d in t_devices.PAPER_CLIENTS]
    cuts = list(t_devices.PAPER_CUTS)
    for policy in ("ours", "fifo", "wf", "bw", "optimal"):
        jo = j_sched.resolve_order(policy, jt, cuts, tfl)
        to = t_sched.resolve_order(policy, tt, cuts, tfl)
        assert jo == to
        assert j_cost.makespan(jt, jo) == t_cost.makespan(tt, to)
    assert j_sched.alg2_priorities(cuts, tfl) == t_sched.alg2_priorities(cuts, tfl)
    for cut in range(13):
        assert j_cost.lora_upload_bytes(jcfg, cut) == t_cost.lora_upload_bytes(tcfg, cut)


def test_devices_bit_equal():
    for name in ("PAPER_CLIENTS", "SERVER", "LINK"):
        j, t = getattr(j_devices, name), getattr(t_devices, name)
        if isinstance(j, tuple):
            assert [dataclasses.asdict(x) for x in j] == [dataclasses.asdict(x) for x in t]
        else:
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j_devices.PAPER_CUTS == t_devices.PAPER_CUTS


@pytest.mark.parametrize("shape", [(16, 128, 768), (4, 16, 128), (7,), (3, 0, 5)])
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_transport_bytes_bit_equal(shape, dtype_bytes):
    for quantized in (False, True):
        assert (t_transport_bytes(shape, quantized, dtype_bytes)
                == j_transport_bytes(shape, quantized, dtype_bytes))


def test_metrics_bit_equal():
    rs = np.random.default_rng(0)
    pred, gold = rs.integers(0, 6, 300), rs.integers(0, 6, 300)
    assert j_metrics.accuracy(pred, gold) == t_metrics.accuracy(pred, gold)
    assert j_metrics.macro_f1(pred, gold) == t_metrics.macro_f1(pred, gold)


@pytest.mark.parametrize("groups", [
    {},
    {"agg": {"interval": 2}},
    {"agg": {"policy": "buffered", "interval": 1}},
    {"engine": {"slots": 2}},
    {"engine": {"mode": "event"}, "scheme": "sfl"},
    {"fleet": {"edge_cells": 7}},
])
def test_run_config_validation_matches(groups):
    def build(mod):
        kw = {"scheme": groups.get("scheme", "ours")}
        for group, cls in (("agg", "AggConfig"), ("engine", "EngineConfig"),
                           ("fleet", "FleetConfig")):
            if group in groups:
                kw[group] = getattr(mod, cls)(**groups[group])
        return mod.FedRunConfig(**kw)

    outcomes = []
    for mod in (j_fedcfg, t_fedcfg):
        try:
            mod.validate_run_config(build(mod), 6)
            outcomes.append(None)
        except (KeyError, ValueError) as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("arch,batch,seq,kw", [
    ("bert-base", 16, 128, {}),
    ("bert-base", 8, 32, {"max_cut": 4, "mem_fraction": 0.01}),
    ("bert-base", 64, 512, {"latency_budget_s": 2.0}),
    ("gemma-2b", 4, 256, {"mem_fraction": 0.3}),
])
def test_partition_bit_equal(arch, batch, seq, kw):
    """assign_cuts, cut_bounds, feasible_cut and the two ceilings over the
    paper clients, on the port's memory model against the reference's."""
    jc, tc = j_configs.REGISTRY[arch], t_configs.REGISTRY[arch]
    jd, td = j_devices.PAPER_CLIENTS, t_devices.PAPER_CLIENTS
    assert (t_part.assign_cuts(tc, td, batch, seq, **kw)
            == j_part.assign_cuts(jc, jd, batch, seq, **kw))
    mem_kw = {k: v for k, v in kw.items() if k != "max_cut"}
    for jdev, tdev in zip(jd, td):
        assert (t_part.feasible_cut(tc, tdev, batch, seq, **mem_kw)
                == j_part.feasible_cut(jc, jdev, batch, seq, **mem_kw))
        assert (t_part.cut_bounds(tc, tdev, batch, seq, **kw)
                == j_part.cut_bounds(jc, jdev, batch, seq, **kw))
        assert (t_part.max_cut_for_compute(tc, tdev, batch, seq)
                == j_part.max_cut_for_compute(jc, jdev, batch, seq))


# ---------------------------------------------------------------------------
# the population-scale copies: fed/fleet, fed/population,
# fed/population_async and make_fleet / make_link_fleet of fed/devices
# ---------------------------------------------------------------------------

from repro.fed import fleet as j_fleet  # noqa: E402
from repro.fed import population as j_pop  # noqa: E402
from repro.fed import population_async as j_pop_async  # noqa: E402
from repro_torch.fed import fleet as t_fleet  # noqa: E402
from repro_torch.fed import population as t_pop  # noqa: E402
from repro_torch.fed import population_async as t_pop_async  # noqa: E402

FLEET_SPECS = [dict(n=13, seed=0, link_model="constant"),
               dict(n=9, seed=5, link_model="trace", jitter=0.1, link_jitter=0.2),
               dict(n=7, seed=2, link_model="gilbert", bad_fraction=0.3)]


def _same_links(jl, tl):
    """Same process, same parameters: the same finish instants for the same
    queries, in order (a Gilbert-Elliott link draws its states lazily)."""
    assert [type(x).__name__ for x in jl] == [type(x).__name__ for x in tl]
    for a, b in zip(jl, tl):
        assert a.nominal_mbps == b.nominal_mbps and a.state_dict() == b.state_dict()
        for t0, nbytes in ((0.0, 1e6), (0.7, 5e6), (3.1, 2e5), (40.0, 8e6)):
            assert a.finish_time(t0, nbytes) == b.finish_time(t0, nbytes)


@pytest.mark.parametrize("kw", FLEET_SPECS, ids=[s["link_model"] for s in FLEET_SPECS])
def test_fleet_spec_bit_equal(kw):
    js, ts = j_fleet.FleetSpec(**kw), t_fleet.FleetSpec(**kw)
    assert [dataclasses.asdict(d) for d in js.devices()] == \
        [dataclasses.asdict(d) for d in ts.devices()]
    _same_links(js.links(), ts.links())
    assert js.cuts() == ts.cuts() and js.memory_budgets() == ts.memory_budgets()
    np.testing.assert_array_equal(js.coords(), ts.coords())
    np.testing.assert_array_equal(js._nominal_rates(), ts._nominal_rates())
    for override in (None, 42.0):
        jp, tp = js.population(override), ts.population(override)
        for field in ("tflops", "utilization", "mem_gb", "cuts", "rate_mbps", "coords"):
            a, b = getattr(jp, field), getattr(tp, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jp.capability_ranks(), tp.capability_ranks())


def test_fleet_functions_and_tpu_profile_bit_equal():
    """The deprecated fleet functions warn as the reference's do and delegate to
    FleetSpec; the reference's modelled TPU server profile is copied as
    cost-model data."""
    assert dataclasses.asdict(t_devices.TPU_V5E) == dataclasses.asdict(j_devices.TPU_V5E)
    for kw in ({}, {"jitter": 0.4}):
        with pytest.warns(DeprecationWarning, match="make_fleet is deprecated"):
            got = t_devices.make_fleet(11, 3, **kw)
        with pytest.warns(DeprecationWarning):
            want = j_devices.make_fleet(11, 3, **kw)
        assert [dataclasses.asdict(d) for d in got] == [dataclasses.asdict(d) for d in want]
    for kw in ({"model": "constant"}, {"model": "trace", "dwell_s": 0.25},
               {"model": "gilbert", "p_gb": 0.3}):
        with pytest.warns(DeprecationWarning, match="make_link_fleet is deprecated"):
            got = t_devices.make_link_fleet(6, 2, **kw)
        with pytest.warns(DeprecationWarning):
            want = j_devices.make_link_fleet(6, 2, **kw)
        _same_links(want, got)


@pytest.mark.parametrize("sampling,rate,alpha", [("full", 1.0, 1.16), ("uniform", 0.3, 1.16),
                                                 ("pareto", 0.25, 1.16),
                                                 ("pareto", 0.6, 2.5)])
def test_sample_cohort_streams_bit_equal(sampling, rate, alpha):
    ranks = j_fleet.FleetSpec(n=40, seed=1).population().capability_ranks()
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        assert (t_pop.sample_cohort(tr, 40, sampling, rate, ranks=ranks, pareto_alpha=alpha)
                == j_pop.sample_cohort(jr, 40, sampling, rate, ranks=ranks,
                                       pareto_alpha=alpha))
    assert tr.bit_generator.state == jr.bit_generator.state
    np.testing.assert_array_equal(t_pop.pareto_weights(ranks, alpha),
                                  j_pop.pareto_weights(ranks, alpha))


def _round_fields(res):
    return (res.round_time, res.completion, res.waits, res.dropped, res.events,
            [(r.slot, r.uids, r.start, r.end) for r in res.service])


def _job_arrays(mod, seed, n=30):
    rng = np.random.default_rng(seed)
    cols = {k: rng.uniform(lo, hi, n) for k, lo, hi in (
        ("t_f", 0.2, 2.0), ("t_fc", 0.1, 1.0), ("t_s", 0.3, 1.5), ("t_bc", 0.1, 1.0),
        ("t_b", 0.2, 1.0), ("arrival", 0.0, 0.5), ("priority", 0.0, 3.0),
        ("fc_bytes", 1e5, 5e6), ("bc_bytes", 1e5, 5e6))}
    return mod.JobArrays(uids=np.arange(n), **cols)


@pytest.mark.parametrize("policy,fixed,plane", [("fifo", False, "none"),
                                                ("wf", False, "constant"),
                                                ("priority", False, "shared"),
                                                ("bw", False, "constant"),
                                                ("fifo", True, "constant")])
def test_vectorized_round_bit_equal(policy, fixed, plane):
    from repro.net import ConstantLink as JLink
    from repro.net import NetworkPlane as JPlane
    from repro_torch.net import ConstantLink as TLink
    from repro_torch.net import NetworkPlane as TPlane

    rates = np.random.default_rng(99).uniform(20.0, 120.0, 30)
    planes = []
    for Plane, Link in ((JPlane, JLink), (TPlane, TLink)):
        planes.append(None if plane == "none" else Plane(
            [Link(float(r)) for r in rates], shared=plane == "shared",
            capacity_mbps=150.0 if plane == "shared" else None))
    ja, ta = _job_arrays(j_pop, 7), _job_arrays(t_pop, 7)
    order = [int(u) for u in np.argsort(-ja.t_s)] if fixed else None
    kw = dict(policy=policy, order=order, slots=3, cohort_chunk=2, chunk_efficiency=0.8,
              deadline=6.0, t_origin=37.5)
    want = j_pop.vectorized_round(ja, network=planes[0], **kw)
    got = t_pop.vectorized_round(ta, network=planes[1], **kw)
    assert _round_fields(got) == _round_fields(want)


def _pop_cfgs():
    return (j_configs.reduced(j_configs.REGISTRY["bert-base"], n_layers=4, d_model=64),
            t_configs.reduced(t_configs.REGISTRY["bert-base"], n_layers=4, d_model=64))


def test_step_time_arrays_bit_equal():
    jc, tc = _pop_cfgs()
    fleet = j_fleet.FleetSpec(n=50, seed=2, link_model="trace").population()
    want = j_pop.step_time_arrays(jc, fleet, j_devices.SERVER, 16, 128)
    got = t_pop.step_time_arrays(tc, t_fleet.FleetSpec(n=50, seed=2, link_model="trace")
                                 .population(), t_devices.SERVER, 16, 128)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


POP_RUNS = {
    "sync-pareto-stragglers-kmeans": dict(
        agg=("sync", 2, "nominal"), fleet=dict(sampling="pareto", rate=0.05,
                                               straggler_prob=0.3, edge_cells=4,
                                               cell_assignment="kmeans")),
    "sync-uniform-plane-blocks": dict(
        agg=("sync", 1, "plane"), fleet=dict(sampling="uniform", rate=0.04, edge_cells=3)),
    "sync-optimal-order": dict(
        agg=("sync", 1, "nominal"), fleet=dict(sampling="pareto", rate=0.03),
        scheduler="optimal"),
    "async-buffered": dict(agg=("buffered", 1, "nominal"), fleet={}, rounds=1),
}


def _pop_run(mod, spec):
    policy, interval, transport = spec["agg"]
    return mod.FedRunConfig(
        rounds=spec.get("rounds", 3), batch_size=16, seq_len=128, seed=1,
        engine=mod.EngineConfig(mode="event", scheduler=spec.get("scheduler", "ours"),
                                slots=2, cohort_chunk=4, chunk_efficiency=0.9),
        agg=mod.AggConfig(policy=policy, interval=interval, transport=transport,
                          buffer_k=500 if policy != "sync" else None),
        fleet=mod.FleetConfig(population_threshold=50, **spec["fleet"]))


@pytest.mark.parametrize("name", list(POP_RUNS))
def test_population_clock_bit_equal(name):
    """The PopulationClock without a trainer over a 2000-client fleet: every
    round's makespan, commit instant, cohort size, mode and service record
    (sync, vectorized rounds), or the SoA async kernel's commits."""
    jc, tc = _pop_cfgs()
    jf = j_fleet.FleetSpec(n=2000, seed=4, link_model="constant").population()
    tf = t_fleet.FleetSpec(n=2000, seed=4, link_model="constant").population()
    want = j_pop.PopulationClock(jc, jf, _pop_run(j_fedcfg, POP_RUNS[name])).run()
    got = t_pop.PopulationClock(tc, tf, _pop_run(t_fedcfg, POP_RUNS[name])).run()
    for field in ("makespan", "round_makespans", "commit_times", "cohort_sizes",
                  "events_processed", "modes"):
        assert getattr(got, field) == getattr(want, field), field
    assert set(got.modes) == {"vectorized"} and got.makespan > 0
    assert [_round_fields(r) for r in got.round_results] == \
        [_round_fields(r) for r in want.round_results]


@pytest.mark.parametrize("policy,agg,k,inflight,slots,chunk",
                         [("fifo", "buffered", 3, 1, 1, 1), ("wf", "buffered", 4, 2, 2, 2),
                          ("priority", "staleness", 2, 2, 1, 2),
                          ("bw", "staleness", 3, 2, 3, 2)])
def test_run_async_vectorized_bit_equal(policy, agg, k, inflight, slots, chunk):
    from repro.fed.engine import ClockConfig as JClockConfig
    from repro_torch.fed.engine import ClockConfig as TClockConfig

    rng = np.random.default_rng(100)
    times = {key: rng.uniform(lo, hi, 10) for key, lo, hi in (
        ("t_f", 0.2, 2.0), ("t_fc", 0.1, 1.0), ("t_s", 0.3, 1.5), ("t_bc", 0.1, 1.0),
        ("t_b", 0.2, 1.0), ("fc_bytes", 1e5, 5e6), ("bc_bytes", 1e5, 5e6))}
    times["fc_bytes"][::3] = 0.0          # rows billed at nominal seconds
    rates = rng.uniform(20.0, 120.0, 10)
    pri = rng.uniform(0.0, 3.0, 10) if policy == "priority" else None
    kw = dict(policy=policy, slots=slots, cohort_chunk=chunk,
              chunk_efficiency=0.9 if chunk > 1 else 1.0, agg_policy=agg, agg_interval=1,
              buffer_k=k, max_inflight_rounds=inflight)
    want, jn = j_pop_async.run_async_vectorized(times, 3, JClockConfig(**kw),
                                                up_rate_mbps=rates, down_rate_mbps=rates,
                                                priorities=pri)
    got, tn = t_pop_async.run_async_vectorized(times, 3, TClockConfig(**kw),
                                               up_rate_mbps=rates, down_rate_mbps=rates,
                                               priorities=pri)
    assert tn == jn and got.makespan == want.makespan
    assert [dataclasses.astuple(e) for e in got.serves] == \
        [dataclasses.astuple(e) for e in want.serves]
    assert [dataclasses.astuple(e) for e in got.commits] == \
        [dataclasses.astuple(e) for e in want.commits]
    assert got.events == want.events and got.rounds_completed == want.rounds_completed
