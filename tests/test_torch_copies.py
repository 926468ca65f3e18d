"""The port's copies of the JAX package's numpy-only modules (the eleven
configs, ``reduced`` and the input shapes, data,
cost model, scheduling, devices, metrics, run config, the wire-byte count of
the transport compression, capacity-based partitioning) stay bit-equal to
their originals on seeded inputs.  The copies of the network plane
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
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


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
    assert list(t_configs.REGISTRY) == list(j_configs.REGISTRY)
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
