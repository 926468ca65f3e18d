"""The frozen work counts against hand counts, and the model-FLOP count of
a server step against the program's own count of every matrix product it
dispatches (``launch.cost_analysis.trace`` on ``meta``): the two differ by
exactly the work the model count leaves out as not useful."""
import pytest
import torch

from conftest import small_cell
from harness import weights, work


def test_lora_call_by_hand():
    flops, nbytes = work.lora_call(m=4, k=3, n=5, r=2, groups=1, elt=2)
    assert flops == 2 * 4 * 3 * 5 + 2 * 4 * 2 * (3 + 5)
    assert nbytes == 2 * (4 * 3 + 3 * 5 + 2 * 3 + 5 * 2 + 4 * 5)
    _, grouped = work.lora_call(m=4, k=3, n=5, r=2, groups=3, elt=4)
    assert grouped == 4 * (4 * 3 + 3 * 5 + 3 * 2 * (3 + 5) + 4 * 5)


def test_bound_takes_the_longer_of_operations_and_bytes():
    assert work.call_bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert work.call_bound_s(1.0, 3.35e12, "float32") == pytest.approx(1.0)
    # fp32 against 3xTF32: a third of the TF32 tensor cores' dense 494.5 TFLOP/s
    assert work.call_bound_s(494.5e12 / 3, 1.0, "float32") == pytest.approx(1.0)


def test_causal_pairs_and_attention_by_hand():
    assert work.causal_pairs(4) == 10
    mc = small_cell("granite-3-2b.server-seq").mc
    mc = dict(mc, lora=dict(mc["lora"], targets=[]), d_ff=0)
    # no projection adapted, no MLP: the projections and attention alone
    seqs, s = 2, 4
    d, h, dh, kv = mc["d_model"], mc["n_heads"], mc["head_dim"], mc["n_kv_heads"]
    proj = 2.0 * seqs * s * (d * h * dh + 2 * d * kv * dh + h * dh * d)
    attn = 4.0 * seqs * h * dh * 10
    assert work.layer_flops(mc, seqs, s, backward=False) == proj + attn
    assert work.layer_flops(mc, seqs, s, backward=True) == 2 * proj + 3 * attn


def test_projection_calls_count_the_launches_a_step_needs():
    mc = small_cell("granite-3-2b.server-seq").mc
    calls = work.projection_calls(mc, rows=8, layers=3, groups=1, input_grad_first=True)
    assert len(calls) == 3 * 4 * 2
    first = work.projection_calls(mc, rows=8, layers=3, groups=1, input_grad_first=False)
    assert len(first) == 3 * 4 * 2 - 3      # no input gradient of layer 0's q, k, v


def test_server_step_flops_against_the_programs_trace_on_meta():
    """cost_analysis counts every product as dispatched; the model count
    leaves out the naive attention's masked pairs (it forms the whole
    square) and the adapters' x A^T formed again for dB."""
    from repro_torch.core import splitfl
    from repro_torch.launch.cost_analysis import trace
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from harness import port

    cell = small_cell("granite-3-2b.server-seq")
    mc, tr = cell.mc, cell.traffic
    seqs, s, cut = tr["seqs"], tr["seq_len"], 2
    model = build_model(port.model_config(mc), "meta")
    params = model.params_spec()
    from repro_torch.tree import tree_map
    lora = tree_map(lambda a: a.to("meta"), weights.adapters(mc, 1, "p", "cpu", 0.1, lo=cut))
    opt = AdamW(1e-4)
    step = splitfl.make_server_step(model, opt, path="sliced", static_cut=cut)
    v = torch.empty((seqs, s, mc["d_model"]), dtype=torch.bfloat16, device="meta")
    ids = torch.empty((seqs, s), dtype=torch.int64, device="meta")
    _, costs = trace(step, params, lora, opt.init(lora), v, {"tokens": ids, "targets": ids})
    n = mc["n_layers"] - cut
    t, r = seqs * s, mc["lora"]["rank"]
    d, qo, kvo = mc["d_model"], mc["n_heads"] * mc["head_dim"], mc["n_kv_heads"] * mc["head_dim"]
    recompute = n * 2.0 * t * r * (d + d + d + qo)          # x A^T of q, k, v, o
    masked = n * 12.0 * seqs * mc["n_heads"] * mc["head_dim"] * (s * s - work.causal_pairs(s))
    expected = work.server_step_flops(mc, seqs, s, cut) + recompute + masked
    assert costs.flops == pytest.approx(expected, rel=1e-9)
