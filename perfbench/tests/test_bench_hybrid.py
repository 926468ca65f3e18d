"""CPU tests of the per-layer hybrid's cell (``granite-4.0-h-micro.server-seq``)
at a cut size: a whole run reads correct, and not with a fault planted in
the timed path or the control in the program's place; the benchmark's
plain reference agrees with the repository's (``tests/plain_granite_hybrid.py``)
on the same seeded inputs; the frozen work counts against the program's
own count of every product it dispatches on ``meta``."""
import copy
import importlib.util
import time

import pytest
import torch

import faults
from conftest import BENCH
from harness import cells, compare, runner, weights, work_hybrid
from harness import work as W
from plainref import hybrid as ref_hybrid
from plainref.numerics import Precision

CELL = "granite-4.0-h-micro.server-seq"
N_LAYERS = 5
SMALL_MC = dict(n_layers=N_LAYERS, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                vocab_size=512, wkv_chunk=8, ssm={"d_state": 16, "d_conv": 4, "expand": 2,
                                                  "head_dim": 32},
                layer_types=["mamba", "mamba", "attention", "mamba", "mamba"])
SMALL_TRAFFIC = dict(phones=[{"cut": c} for c in (1, 1, 2, 2, 3, 3)], seqs=2, seq_len=16,
                     pool=2)


def small_cell():
    """The cell with its widths and sizes cut for the CPU (both mixers kept,
    cuts below and above the attention layer; its comparison and limits
    kept)."""
    cell = cells.load_cell(CELL)
    cell.mc.update(copy.deepcopy(SMALL_MC))
    cell.traffic.update(copy.deepcopy(SMALL_TRAFFIC))
    return cell


def _run(cell, trace=False):
    return runner.execute(cell, 2**31 + 977, 0.5, trace, "cpu", time.time())


def test_sound_run_is_correct():
    res = _run(small_cell())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"tokens_per_s", "peak_mem_gb", "setup_s"}


def test_traced_run_reads_no_device_metric_on_the_cpu():
    res = _run(small_cell(), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    faults.plant(monkeypatch, CELL, fault)
    res = _run(small_cell())
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    cell = small_cell()
    kind = cells.kind(cell.traffic["kind"])
    seed = 2**31 + 5
    ref = kind.reference(cell.mc, cell.traffic, seed, "cpu")
    control = kind.reference(cell.mc, cell.traffic, seed, "cpu", "fp8")
    assert not compare.all_ok(compare.check(compare.numbers(control, ref), cell.limits))


def test_parent_without_the_model_fails_at_once(monkeypatch):
    """A program whose ``ModelConfig`` lacks the per-layer hybrid's fields
    (the parent commit's) raises in set-up, before any weight is made."""
    from repro_torch.configs import base
    kind = cells.kind("server_seq_hybrid")
    cell = small_cell()
    fields = {f for f in base.ModelConfig.__dataclass_fields__ if f != "layer_types"}

    def old(**kw):
        unknown = set(kw) - fields - {"lora"}
        if unknown:
            raise TypeError(f"unexpected keyword argument {sorted(unknown)[0]!r}")
    monkeypatch.setattr(base, "ModelConfig", old)
    with pytest.raises(TypeError, match="layer_types"):
        kind.Program(cell.mc, cell.traffic, 1, "cpu").setup()


def _tests_reference():
    path = BENCH.parent / "tests" / "plain_granite_hybrid.py"
    spec = importlib.util.spec_from_file_location("plain_granite_hybrid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plainref_agrees_with_the_repositorys_reference():
    """The two references on the same seeded weights, adapters and upload,
    float32: the loss, ``dv`` and each adapter's gradient (the benchmark's
    in blocks of one row) agree to float32 rounding."""
    cell = small_cell()
    mc, tr = cell.mc, cell.traffic
    kind = cells.kind("server_seq_hybrid")
    seed, cut = 2**31 + 9, 1
    params = kind.params(dict(mc, dtype="float32"), seed, "cpu")
    flat = kind.flat_adapters(mc, kind.adapters(mc, seed, "p", "cpu", 0.05, lo=cut), cut,
                              mc["n_layers"])
    v = weights.normal((2, tr["seq_len"], mc["d_model"]), 1.0, torch.float32, "cpu", seed, "v")
    targets = weights.randint(mc["vocab_size"], (2, tr["seq_len"]), "cpu", seed, "t")
    from plainref.adamw import Adam
    loss, dv, grads, _, _ = ref_hybrid.server_step(mc, Precision("fp32"), params, flat, None, v,
                                                   targets, cut, Adam(1e-4, 0.9, 0.999, 1e-8), 1)
    other = _tests_reference()
    want_loss, want_dv, want_g, _ = other.server_step(mc, params, flat, v, targets, cut, lr=1e-4)
    assert abs(loss - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    assert float((dv - want_dv).norm() / want_dv.norm()) <= 1e-5
    for n, g in grads.items():
        assert float((g - want_g[n]).norm()) <= 1e-5 * float(want_g[n].norm()), n


def test_server_step_flops_against_the_programs_trace_on_meta(monkeypatch):
    """cost_analysis counts every product as dispatched; the frozen count
    leaves out the naive attention's masked pairs, the adapters' x A^T
    formed again for dB, the SSD's masked pairs, its zero-state and unread
    chunk terms and its recompute in the backward, and counts the conv,
    which the program computes without a product op."""
    from repro_torch.core import splitfl
    from repro_torch.launch.cost_analysis import trace
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_map

    cell = small_cell()
    mc, tr = cell.mc, cell.traffic
    kind = cells.kind("server_seq_hybrid")
    monkeypatch.setattr(work_hybrid, "SSD_CHUNK", mc["wkv_chunk"])
    seqs, s, cut = tr["seqs"], tr["seq_len"], 1
    model = build_model(kind.model_config(mc), "meta")
    lora = tree_map(lambda a: a.to("meta"), kind.adapters(mc, 1, "p", "cpu", 0.1, lo=cut))
    opt = AdamW(1e-4)
    step = splitfl.make_server_step(model, opt, path="sliced", static_cut=cut)
    v = torch.empty((seqs, s, mc["d_model"]), dtype=torch.bfloat16, device="meta")
    ids = torch.empty((seqs, s), dtype=torch.int64, device="meta")
    _, costs = trace(step, model.params_spec(), lora, opt.init(lora), v,
                     {"tokens": ids, "targets": ids})

    t, r, d = seqs * s, mc["lora"]["rank"], mc["d_model"]
    kinds = mc["layer_types"][cut:]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    io, conv_ch = work_hybrid.mamba_io(mc)
    ss = mc["ssm"]
    h, p, n, q = ss["expand"] * d // ss["head_dim"], ss["head_dim"], ss["d_state"], mc["wkv_chunk"]
    full_fwd = (s // q) * (2.0 * q * q * n + 2.0 * h * q * q * p + 4.0 * q * h * p * n)
    ssd_dispatched = 4 * seqs * full_fwd           # forward, recompute, backward (2x)
    recompute = (n_mamba * 2.0 * t * r * (io["in_proj"][0] + io["out_proj"][0])
                 + n_attn * 2.0 * t * r * (d + d + d + mc["n_heads"] * mc["head_dim"]))
    masked = n_attn * 12.0 * seqs * mc["n_heads"] * mc["head_dim"] * (s * s - W.causal_pairs(s))
    conv = n_mamba * 2 * 2.0 * ss["d_conv"] * conv_ch * t
    expected = (work_hybrid.server_step_flops(mc, seqs, s, cut) + recompute + masked - conv
                + n_mamba * (ssd_dispatched - work_hybrid.ssd_flops(mc, seqs, s)))
    assert costs.flops == pytest.approx(expected, rel=1e-9)


def test_projection_calls_count_the_launches_a_step_needs():
    mc = small_cell().mc
    calls = work_hybrid.projection_calls(mc, rows=8, cut=1)
    # layers 1..4: three Mamba2 layers (in_proj, out_proj), one attention (q, k, v, o),
    # each call's forward and its input gradient
    assert len(calls) == 3 * 2 * 2 + 4 * 2
    assert calls[:2] == [(8, 128, 2 * 256 + 2 * 16 + 8, mc["lora"]["rank"], 1),
                         (8, 2 * 256 + 2 * 16 + 8, 128, mc["lora"]["rank"], 1)]


def _record(wall, steps=2):
    """``steps`` server steps of one Mamba2 layer by hand: the step 10 s of
    device time, the SSD 2 s forward and 3 s backward inside the mixer's
    4 s and 5 s; the mixer leaves 6 GB allocated, 40 GB are live at the
    backward."""
    st = wall._state
    gb = 10**9

    def add(name, req, parent, dev, held=None, entry=None):
        s = object.__new__(wall.Span)
        s.name, s.req, s.id, s.parent = name, req, st.next_id, parent
        st.next_id += 1
        s.events, s.dropped, s.device_s = None, False, dev
        s.bytes_in = s.bytes_out = None
        if held is not None:
            s.bytes_in, s.bytes_out = entry, entry + held
        st.ring.append(s)
        return s.id

    for _ in range(steps):
        req, st.next_req = st.next_req, st.next_req + 1
        step = add("server_step", req, None, 10.0, 0, 30 * gb)
        fwd = add("forward", req, step, 4.5, 7 * gb, 30 * gb)
        mixer = add("mamba", req, fwd, 4.0, 6 * gb, 31 * gb)
        add("ssd", req, mixer, 2.0, 1 * gb, 33 * gb)
        bwd = add("backward", req, step, 5.0, -6 * gb, 40 * gb)
        mixer_bwd = add("mamba.bwd", req, bwd, 5.0)
        add("ssd.bwd", req, mixer_bwd, 3.0)


@pytest.mark.parametrize("metric,want", [("ssd_share", 100.0 * (2 + 3) / 10),
                                         ("mamba_tape_share", 100.0 * 6 / 40)])
def test_span_readers_read_their_formula_and_nothing_without_spans(metric, want):
    import types
    from repro_torch.obs import wall
    ctx = types.SimpleNamespace(work={"attempted": 2})
    wall.reset()
    try:
        assert cells.metric_reader(metric).read(ctx) is None
        _record(wall)
        assert cells.metric_reader(metric).read(ctx) == pytest.approx(want)
    finally:
        wall.reset()
