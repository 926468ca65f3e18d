"""The port's MoE block against the JAX package's, from bridged weights, on
reduced qwen3-moe-30b-a3b (silu experts, top-2 of 4 after ``reduced``) and
grok-1-314b (geglu experts) in fp32: ``_router``, ``_moe_group_sorted``
(with tokens dropped at the capacity), ``_moe_group_dense`` and
``moe_mlp`` with one and two dispatch groups, aux loss included; the
router's and the attention's adapter gradients against ``jax.grad``; and
on qwen3-moe the LM split steps — the full train step, the LM server step
on the sliced and the scan path, and both impls of
``make_server_step_batched`` — against the reference's.  Last, the port's
own rule for concatenated lanes: a vmap lane equals the same lane run
alone, aux included.

Tolerances: outputs and losses at rtol 1e-4 / atol 2e-5 (fp32 sums in
another order, as tests/test_torch_lm.py); gradients at 1e-4 in the
relative 2-norm; adapters after AdamW at 2*lr per element and step
(ROADMAP Queue C); expert ids and kept slots exactly.
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

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.core import splitfl as j_splitfl  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.core import splitfl  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

set_fp32_policy()

RTOL, ATOL = 1e-4, 2e-5
GRAD_TOL = 1e-4
LR = 1e-3
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
N_LAYERS = 2
BATCH, SEQ = 2, 12
TOKENS = 40


def _cfgs(arch, impl="einsum", **kw):
    jc = j_reduced(J_REGISTRY[arch], n_layers=N_LAYERS).with_(**kw)
    tc = reduced(REGISTRY[arch], n_layers=N_LAYERS).with_(**kw)
    return (jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)),
            tc.with_(lora=dataclasses.replace(tc.lora, impl=impl)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _close_trees(got, want, **kw):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close_trees(got[k], want[k], **kw)
    else:
        _close(got, want, **kw)


def _rel2(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _norm_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_norm_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_tree_norm_err(got[k], want[k]) for k in got)
    return _norm_err(got, want)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(cfg, rs, lead=(BATCH,)):
    return {"tokens": rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32),
            "targets": rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)}


def _state(arch):
    jc, _ = _cfgs(arch)
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return arch, params, lora, _batch(jc, rs)


@pytest.fixture(scope="module", params=ARCHS)
def state(request):
    return _state(request.param)


@pytest.fixture(scope="module")
def qwen():
    """The split steps run on qwen3-moe alone: grok's block is the same
    code with geglu experts and top-2 of 4 (after ``reduced``) as well."""
    return _state("qwen3-moe-30b-a3b")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _x(cfg, seed, t=TOKENS):
    return (np.random.default_rng(seed).standard_normal((t, cfg.d_model))).astype(np.float32)


# ---------------------------------------------------------------- the functions

@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_router_matches_reference(state, impl):
    arch, params, lora, _ = state
    jc, tc = _cfgs(arch, impl)
    p, lo = _layer0(params["layers"]), _layer0(lora["layers"])
    x = _x(jc, 1)
    jg, je, jp = JB._router(jc, _jtree(p), _jtree(lo), jnp.asarray(x))
    tg, te, tp = B._router(tc, to_torch(p, "cpu"), to_torch(lo, "cpu"), torch.from_numpy(x))
    assert tp.dtype == torch.float32 and tuple(te.shape) == (TOKENS, tc.moe.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    _close(tp, jp)


def _drops(cfg, eidx) -> int:
    """Entries beyond their expert's capacity in a group of routed tokens."""
    m = cfg.moe
    n = eidx.size
    cap = max(1, int(np.ceil(n / m.num_experts * m.capacity_factor)))
    counts = np.bincount(np.asarray(eidx).reshape(-1), minlength=m.num_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("capacity", [1.0, 0.5])
def test_moe_group_sorted_matches_reference_with_drops(state, capacity):
    arch, params, lora, _ = state
    jc, tc = (c.with_(moe=dataclasses.replace(c.moe, capacity_factor=capacity))
              for c in _cfgs(arch))
    p, lo = _layer0(params["layers"]), _layer0(lora["layers"])
    x = _x(jc, 2)
    _, eidx, _ = JB._router(jc, _jtree(p), _jtree(lo), jnp.asarray(x))
    assert _drops(jc, eidx) > 0           # the capacity drops some entries
    jout, jaux = JB._moe_group_sorted(jc, _jtree(p), _jtree(lo), jnp.asarray(x))
    tout, taux = B._moe_group_sorted(tc, to_torch(p, "cpu"), to_torch(lo, "cpu"),
                                     torch.from_numpy(x))
    _close(tout, jout)
    _close(taux, jaux)


def test_moe_group_dense_matches_reference(state):
    arch, params, lora, _ = state
    jc, tc = _cfgs(arch)
    p, lo = _layer0(params["layers"]), _layer0(lora["layers"])
    x = _x(jc, 3, t=6)
    jout, jaux = JB._moe_group_dense(jc, _jtree(p), _jtree(lo), jnp.asarray(x))
    tout, taux = B._moe_group_dense(tc, to_torch(p, "cpu"), to_torch(lo, "cpu"),
                                    torch.from_numpy(x))
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("groups,dense", [(1, False), (2, False), (2, True)])
def test_moe_mlp_matches_reference(state, groups, dense):
    arch, params, lora, _ = state
    jc, tc = _cfgs(arch)
    p, lo = _layer0(params["layers"]), _layer0(lora["layers"])
    x = _x(jc, 4, t=BATCH * SEQ).reshape(BATCH, SEQ, jc.d_model)
    ctx = {"moe_groups": groups, "moe_dense_fallback": dense}
    jout, jaux = JB.moe_mlp(jc, _jtree(p), _jtree(lo), jnp.asarray(x), ctx)
    tout, taux = B.moe_mlp(tc, to_torch(p, "cpu"), to_torch(lo, "cpu"),
                           torch.from_numpy(x), ctx)
    assert taux.dim() == 0
    _close(tout, jout)
    _close(taux, jaux)


def test_moe_aux_rows_give_each_group_its_own_aux(state):
    """``moe_aux_rows``: each row carries its group's aux, and the groups'
    outputs equal each group dispatched alone."""
    arch, params, lora, _ = state
    _, tc = _cfgs(arch)
    p, lo = (to_torch(_layer0(t), "cpu") for t in (params["layers"], lora["layers"]))
    x = torch.from_numpy(_x(tc, 5, t=4 * SEQ).reshape(4, SEQ, tc.d_model))
    out, aux = B.moe_mlp(tc, p, lo, x, {"moe_groups": 2, "moe_aux_rows": True})
    assert tuple(aux.shape) == (4,)
    for g in range(2):
        o, a = B.moe_mlp(tc, p, lo, x[2 * g:2 * g + 2], {})
        assert torch.equal(out[2 * g:2 * g + 2], o)
        assert torch.equal(aux[2 * g], a) and torch.equal(aux[2 * g + 1], a)


# ---------------------------------------------------------------- gradients

@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_router_and_attention_adapter_grads_match_jax_grad(state, impl):
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch, impl)
    jm, tm = j_build(jc), build_model(tc, device="cpu")

    def jloss(lo):
        return jm.loss(_jtree(params), lo, _jtree(batch))[0]

    jg = jax.grad(jloss)(_jtree(lora))
    tl = tree_map(lambda a: a.requires_grad_(True), to_torch(lora, "cpu"))
    tloss, _ = tm.loss(to_torch(params, "cpu"), tl, to_torch(batch, "cpu"), path="scan")
    _close(tloss, jloss(_jtree(lora)))
    tg = torch.autograd.grad(tloss, tree_leaves(tl))
    names = []

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{prefix}/{k}")
        else:
            names.append(prefix)

    walk(tl)
    jleaves = {}

    def jwalk(tree, prefix=""):
        if isinstance(tree, dict):
            for k in tree:
                jwalk(tree[k], f"{prefix}/{k}")
        else:
            jleaves[prefix] = tree

    jwalk(jg)
    assert any("wr_router" in n for n in names) and any("attn" in n for n in names)
    for name, g in zip(names, tg):
        assert _rel2(g, jleaves[name]) <= GRAD_TOL, name


# ---------------------------------------------------------------- split steps

def _split(params, lora, cut, jax_side):
    if jax_side:
        pc = dict(params)
        pc["layers"] = j_lora.slice_stack(params["layers"], 0, cut)
        lc, ls = j_lora.split_lora(lora, cut)
        return pc, lc, j_lora.embed_in_full_shape(ls, jax.eval_shape(lambda: lora), cut,
                                                  "server")
    pc = dict(params)
    pc["layers"] = lora_lib.slice_stack(params["layers"], 0, cut)
    lc, ls = lora_lib.split_lora(lora, cut)
    return pc, lc, lora_lib.embed_in_full_shape(ls, lora, cut, "server")


@pytest.mark.parametrize("remat", [False, True])
def test_full_train_step_matches_reference(qwen, remat):
    arch, params, lora, batch = qwen
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    jstep = j_splitfl.make_full_train_step(jm, jopt, remat=remat, donate=False)
    tstep = splitfl.make_full_train_step(tm, topt, remat=remat)
    jl, tl = _jtree(lora), to_torch(lora, "cpu")
    js, ts = jopt.init(jl), topt.init(tl)
    jp, tp = _jtree(params), to_torch(params, "cpu")
    rs = np.random.default_rng(11)
    for i in range(2):
        b = batch if i == 0 else _batch(jc, rs)
        jloss, jl, js = jstep(jp, jl, js, _jtree(b))
        tloss, tl, ts = tstep(tp, tl, ts, to_torch(b, "cpu"))
        _close(tloss, jloss)
        _close_trees(tl, jl, atol=2 * LR * (i + 1), rtol=0)


@pytest.mark.parametrize("path", ["sliced", "scan"])
def test_lm_server_step_matches_reference(qwen, path):
    """The LM server step at cut 1 from the client's activations: the
    sliced path reports no aux; the scan path adds the owned layers'."""
    arch, params, lora, batch = qwen
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    cut = 1
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    jpc, jlc, jls = _split(jp, jl, cut, True)
    tpc, tlc, tls = _split(tp, tl, cut, False)
    jv = j_splitfl.client_forward(jm, jpc, jlc, jb, cut)
    tv = splitfl.client_forward(tm, tpc, tlc, tb, cut)
    _close(tv, jv)
    if path == "scan":
        jstep = j_splitfl.make_server_step(jm, jopt, path="scan", donate=False)
        tstep = splitfl.make_server_step(tm, topt, path="scan")
        jout = jstep(jp, jls, jopt.init(jls), jv, jb, jnp.int32(cut))
        tout = tstep(tp, tls, topt.init(tls), tv, tb, torch.tensor(cut))
    else:
        jstep = j_splitfl.make_server_step(jm, jopt, static_cut=cut, donate=False)
        tstep = splitfl.make_server_step(tm, topt, static_cut=cut)
        jout = jstep(jp, jls, jopt.init(jls), jv, jb)
        tout = tstep(tp, tls, topt.init(tls), tv, tb)
    (jloss, jnl, jno, jdv), (tloss, tnl, tno, tdv) = jout, tout
    _close(tloss, jloss)
    _close(tdv, jdv)
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_norm_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)


def test_sliced_and_scan_server_steps_differ_by_the_aux(qwen):
    """At an int cut the scan path's logits equal the sliced path's bit for
    bit; its loss is the sliced loss plus the owned layers' router aux."""
    arch, params, lora, batch = qwen
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    v = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, tc.d_model)) * 0.5).astype(np.float32))
    for cut in range(N_LAYERS + 1):
        a_loss, a_logits = tm.loss(tp, tl, tb, cut=cut, side="server", x0=v)
        b_loss, b_logits = tm.loss(tp, tl, tb, cut=cut, side="server", x0=v, path="scan")
        _, aux = tm.forward_hidden(tp, tl, tb, cut=cut, side="server", x0=v, path="scan")
        assert torch.equal(a_logits, b_logits)
        assert (float(aux) > 0) == (cut < N_LAYERS)
        assert float(b_loss) == pytest.approx(float(a_loss) + float(aux), rel=1e-6)


COHORT_B = 2
COHORT_CUTS = (1, N_LAYERS, 2, 1)


def _np_cohort(params, lora, cuts, seed=1):
    rs = np.random.default_rng(seed)

    def server_part(cut):
        return jax.tree.map(lambda a: np.concatenate(
            [np.zeros_like(a[:cut]), (rs.standard_normal(a[cut:].shape) * 0.05)
             .astype(np.float32)]), lora)

    lora_s = jax.tree.map(lambda *xs: np.stack(xs), *[server_part(c) for c in cuts])
    d = params["embed"].shape[1]
    vocab = params["embed"].shape[0]
    v = (rs.standard_normal((len(cuts), COHORT_B, SEQ, d)) * 0.5).astype(np.float32)
    batch = {"tokens": rs.integers(0, vocab, (len(cuts), COHORT_B, SEQ)).astype(np.int32),
             "targets": rs.integers(0, vocab, (len(cuts), COHORT_B, SEQ)).astype(np.int32)}
    return lora_s, v, batch


@pytest.mark.parametrize("impl,chunk", [("vmap", 2), ("vmap", None), ("ragged", None)])
def test_lm_cohort_step_matches_reference(qwen, impl, chunk):
    """Per-lane losses (the router aux of each lane's own dispatch under
    vmap), dv and gradients (from the first moment) to 1e-5 of their
    scale, adapters after AdamW to 2*lr."""
    arch, params, lora, _ = qwen
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    lora_s, v, batch = _np_cohort(params, lora, COHORT_CUTS)
    jopt, topt = JAdamW(LR), AdamW(LR)
    jl = _jtree(lora_s)
    jos = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jopt.init(jax.tree.map(lambda a, i=i: a[i], jl)) for i in range(len(COHORT_CUTS))])
    jstep = j_splitfl.make_server_step_batched(jm, jopt, cohort_chunk=chunk, impl=impl,
                                               donate=False)
    jcuts = np.asarray(COHORT_CUTS) if impl == "ragged" else jnp.asarray(COHORT_CUTS)
    jloss, jnl, jno, jdv = jstep(_jtree(params), jl, jos, jnp.asarray(v), _jtree(batch),
                                 jcuts)
    tl = to_torch(lora_s, "cpu")
    tos = lora_lib.stack_trees([topt.init(lo) for lo in lora_lib.unstack_tree(tl)])
    tstep = splitfl.make_server_step_batched(tm, topt, cohort_chunk=chunk, impl=impl)
    tloss, tnl, tno, tdv = tstep(to_torch(params, "cpu"), tl, tos, to_torch(v, "cpu"),
                                 to_torch(batch, "cpu"), list(COHORT_CUTS))
    assert _norm_err(tloss, jloss) <= 1e-5
    assert _norm_err(tdv, jdv) <= 1e-5
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_norm_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)


def test_vmap_lanes_equal_their_own_scan_steps(qwen):
    """Each lane of the port's vmap step equals that client's own LM server
    step on the scan path (a 0-d cut: its own dispatch, aux masked at its
    cut): losses and dv at 1e-6, first moments at 1e-7."""
    arch, params, lora, _ = qwen
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    lora_s, v, batch = _np_cohort(params, lora, COHORT_CUTS, seed=5)
    opt = AdamW(LR)
    tp, tl, tv, tb = (to_torch(x, "cpu") for x in (params, lora_s, v, batch))
    states = [opt.init(lo) for lo in lora_lib.unstack_tree(tl)]
    loss, nl, no, dv = splitfl.make_server_step_batched(tm, opt, impl="vmap")(
        tp, tl, lora_lib.stack_trees(states), tv, tb, list(COHORT_CUTS))
    scan = splitfl.make_server_step(tm, opt, path="scan")
    for i, cut in enumerate(COHORT_CUTS):
        lane = lambda t, i=i: tree_map(lambda a: a[i], t)  # noqa: E731
        sl, snl, sno, sdv = scan(tp, lane(tl), states[i], tv[i], lane(tb), torch.tensor(cut))
        _close(loss[i], sl, atol=1e-6, rtol=0)
        _close(dv[i], sdv, atol=1e-6, rtol=0)
        _close_trees(lane(no.mu), sno.mu, atol=1e-7, rtol=0)
