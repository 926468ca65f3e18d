"""Algorithm 1's split steps in the port: against the JAX package's steps
at a static cut, and the reference's own split-FL invariants (split equals
full, zero server gradient on client layers, the step's dv equals the
end-to-end dv, loss decreasing, the classification server step).

Tolerances: values before the optimizer step (v, loss, dv, gradients) get
rtol 1e-4 / atol 1e-5 — fp32 sums in another order.  Adapters and heads
after one AdamW step get atol 2*lr per element: on the first step m/sqrt(v)
is about +-1, so an element whose gradient is near zero may move by lr the
other way under any reordering of its sum (ROADMAP Queue C.1).
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

from repro_torch.bridge import to_torch
from repro_torch.configs import REGISTRY, reduced
from repro_torch.core import lora as lora_lib
from repro_torch.core import splitfl
from repro_torch.models import build_model
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

set_fp32_policy()

RTOL, ATOL = 1e-4, 1e-5
LR = 1e-3
N_LAYERS = 4


def _cfg(impl="einsum"):
    c = reduced(REGISTRY["bert-base"], n_layers=N_LAYERS, d_model=128)
    return c.with_(lora=dataclasses.replace(c.lora, impl=impl))


def _np_state(seed=0):
    """Seeded numpy weights, adapters (non-zero B), activations and batch,
    shaped as the port's model lays them out."""
    tm = build_model(_cfg(), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    rs = np.random.default_rng(seed)
    params = tree_map(lambda t: t.numpy(), tm.init_params(gen))
    lora = tree_map(lambda t: (rs.standard_normal(tuple(t.shape)) * 0.05).astype(np.float32),
                    tm.init_lora(gen))
    batch = {"tokens": rs.integers(0, 512, (2, 16)).astype(np.int32),
             "label": rs.integers(0, 6, (2,)).astype(np.int32)}
    return params, lora, batch


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _close_trees(got, want, **kw):
    """Leaf by leaf, matched by key path (JAX returns dicts key-sorted)."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close_trees(got[k], want[k], **kw)
    else:
        _close(got, want, **kw)


# ---------------------------------------------------------------- vs the JAX package

@pytest.mark.parametrize("impl,cut", [("einsum", 1), ("einsum", 3), ("fused", 2)])
def test_split_steps_match_reference(impl, cut):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import lora as j_lora
    from repro.core import splitfl as j_splitfl
    from repro.models import build_model as j_build
    from repro.optim import AdamW as JAdamW

    params, lora, batch = _np_state()
    jc = j_reduced(J_REGISTRY["bert-base"], n_layers=N_LAYERS, d_model=128)
    jm = j_build(jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)))
    tm = build_model(_cfg(impl), device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)

    # --- reference
    jp = jax.tree.map(jnp.asarray, params)
    jl = jax.tree.map(jnp.asarray, lora)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpc = dict(jp)
    jpc["layers"] = j_lora.slice_stack(jp["layers"], 0, cut)
    jlc, jls = j_lora.split_lora(jl, cut)
    jls_full = j_lora.embed_in_full_shape(jls, jax.eval_shape(lambda: jl), cut, "server")
    jv, jvjp = j_splitfl.client_forward_with_vjp(jm, jpc, jlc, jb, cut)
    jsrv = j_splitfl.make_server_step_cls(jm, jopt, static_cut=cut)
    jloss, jnl, jnh, _, jdv = jsrv(jp, jls_full, jp["cls_head"],
                                   jopt.init({"lora": jls_full, "head": jp["cls_head"]}),
                                   jv, jb)
    jgc = jvjp(jdv)
    jgs = jax.grad(lambda lo: j_splitfl.server_loss(jm, jp, lo, jv, jb, cut)[0])(jls_full)

    # --- port, from the same numpy state
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    tpc = dict(tp)
    tpc["layers"] = lora_lib.slice_stack(tp["layers"], 0, cut)
    tlc, tls = lora_lib.split_lora(tl, cut)
    tls_full = lora_lib.embed_in_full_shape(tls, tl, cut, "server")
    fwd, bwd = splitfl.make_client_step(tm, topt, cut)
    tv, tape = fwd(tpc, tlc, tb)
    tsrv = splitfl.make_server_step_cls(tm, topt, static_cut=cut)
    tloss, tnl, tnh, _, tdv = tsrv(tp, tls_full, tp["cls_head"],
                                   topt.init({"lora": tls_full, "head": tp["cls_head"]}),
                                   tv, tb)
    tgc = splitfl.client_vjp(tape, tdv)
    leaf = splitfl.as_trainable(tls_full)
    with torch.enable_grad():
        sl, _ = splitfl.server_loss(tm, tp, leaf, tv, tb, cut)
    tgs = splitfl.tree_grad(sl, leaf)[0]

    _close(tv, jv)
    _close(tloss, jloss)
    _close(tdv, jdv)
    _close_trees(tgc, jgc)
    _close_trees(tgs, jgs)
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)
    _close(tnh, jnh, atol=2 * LR, rtol=0)
    _, tape2 = fwd(tpc, tlc, tb)                # a tape backs one backward
    new_c, _ = bwd(tape2, topt.init(tlc), tdv)
    jnew_c, _ = jopt.update(jgc, jopt.init(jlc), jlc)
    _close_trees(new_c, jnew_c, atol=2 * LR, rtol=0)


# ---------------------------------------------------------------- invariants

@pytest.fixture(scope="module")
def port():
    params, lora, batch = _np_state()
    tm = build_model(_cfg(), device="cpu")
    return tm, to_torch(params, "cpu"), to_torch(lora, "cpu"), to_torch(batch, "cpu")


def _client_part(params, lora, cut):
    pc = dict(params)
    pc["layers"] = lora_lib.slice_stack(params["layers"], 0, cut)
    return pc, lora_lib.split_lora(lora, cut)


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_split_composition_equals_full(port, cut):
    tm, params, lora, batch = port
    pc, (lc, _) = _client_part(params, lora, cut)
    with torch.no_grad():
        v = splitfl.client_forward(tm, pc, lc, batch, cut)
        loss_split, _ = splitfl.server_loss(tm, params, lora, v, batch, cut)
        loss_full, _ = tm.loss(params, lora, batch)
    _close(loss_split, loss_full, atol=0, rtol=1e-5)


def test_server_grads_localized(port):
    tm, params, lora, batch = port
    cut = 2
    v = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 128))
                         .astype(np.float32))
    leaf = splitfl.as_trainable(lora)
    with torch.enable_grad():
        loss, _ = splitfl.server_loss(tm, params, leaf, v, batch, cut)
    g = splitfl.tree_grad(loss, leaf)[0]
    client_g, server_g = lora_lib.split_lora(g, cut)
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(client_g))
    assert any(float(x.abs().max()) > 0 for x in tree_leaves(server_g))


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_step_dv_equals_end_to_end_dv(port, impl):
    _, params, lora, batch = port
    tm = build_model(_cfg(impl), device="cpu")
    cut = 2
    pc, (lc, _) = _client_part(params, lora, cut)
    with torch.no_grad():
        v = splitfl.client_forward(tm, pc, lc, batch, cut)
    vv = v.clone().requires_grad_(True)
    with torch.enable_grad():
        (dv_direct,) = torch.autograd.grad(
            splitfl.server_loss(tm, params, lora, vv, batch, cut)[0], (vv,))
    opt = AdamW(LR)
    step = splitfl.make_server_step_cls(tm, opt, static_cut=cut)
    *_, dv_step = step(params, lora, params["cls_head"],
                       opt.init({"lora": lora, "head": params["cls_head"]}), v, batch)
    _close(dv_step, dv_direct, atol=1e-6, rtol=0)


def test_end_to_end_split_training_decreases_loss(port):
    tm, params, lora, batch = port
    cut = 2
    opt = AdamW(5e-3)
    pc, (lc, ls) = _client_part(params, lora, cut)
    ls_full = lora_lib.embed_in_full_shape(ls, lora, cut, "server")
    head = params["cls_head"]
    srv = splitfl.make_server_step_cls(tm, opt, static_cut=cut)
    fwd, bwd = splitfl.make_client_step(tm, opt, cut)
    so, co = opt.init({"lora": ls_full, "head": head}), opt.init(lc)
    losses = []
    for _ in range(8):
        v, tape = fwd(pc, lc, batch)
        loss, ls_full, head, so, dv = srv(params, ls_full, head, so, v, batch)
        lc, co = bwd(tape, co, dv)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.05, losses


def test_classification_server_step(port):
    tm, params, lora, batch = port
    cut = 1
    opt = AdamW(1e-2)
    step = splitfl.make_server_step_cls(tm, opt, static_cut=cut)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 128))
                         .astype(np.float32))
    ost = opt.init({"lora": lora, "head": params["cls_head"]})
    loss, nl, nh, no, dv = step(params, lora, params["cls_head"], ost, v, batch)
    assert np.isfinite(float(loss))
    assert dv.shape == v.shape
    assert float((nh - params["cls_head"]).abs().max()) > 0     # head trains
    assert int(no.step) == 1 and not nh.requires_grad and not dv.requires_grad


# ---------------------------------------------------------------- cohort-batched step

COHORT_B = 2


def _np_cohort(cuts, seed=1):
    """Per-client numpy state for a ragged cohort: full-shape server adapters
    (zero below each client's cut, as the Simulator embeds them), heads,
    received activations and batches, each stacked on a leading lane axis."""
    params, lora, _ = _np_state()
    rs = np.random.default_rng(seed)
    g = len(cuts)

    def server_part(cut):
        return tree_map(lambda a: np.concatenate(
            [np.zeros_like(a[:cut]), (rs.standard_normal(a[cut:].shape) * 0.05)
             .astype(np.float32)]), lora)

    lora_s = tree_map(lambda *xs: np.stack(xs), *[server_part(c) for c in cuts])
    heads = (rs.standard_normal((g,) + params["cls_head"].shape) * 0.1).astype(np.float32)
    v = rs.standard_normal((g, COHORT_B, 16, 128)).astype(np.float32)
    batch = {"tokens": rs.integers(0, 512, (g, COHORT_B, 16)).astype(np.int32),
             "label": rs.integers(0, 6, (g, COHORT_B)).astype(np.int32)}
    return params, lora_s, heads, v, batch


def _norm_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_norm_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_tree_norm_err(got[k], want[k]) for k in got)
    return _norm_err(got, want)


@pytest.mark.parametrize("impl,cuts", [("einsum", (1, 1, 2, 3)), ("fused", (1, 1, 2, 3)),
                                       ("fused", (3, 1, 2, 1))])
def test_ragged_cls_step_matches_reference(impl, cuts):
    """Losses, dv and the adapter and head gradients (read from the first
    moment, mu = (1 - b1) g after one step) to 1e-5 of their scale;
    adapters and heads after the AdamW step to 2*lr (ROADMAP Queue C.1)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import splitfl as j_splitfl
    from repro.models import build_model as j_build
    from repro.optim import AdamW as JAdamW

    params, lora_s, heads, v, batch = _np_cohort(cuts)
    jc = j_reduced(J_REGISTRY["bert-base"], n_layers=N_LAYERS, d_model=128)
    jm = j_build(jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)))
    jopt = JAdamW(LR)
    jp, jl = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora_s)
    jh = jnp.asarray(heads)
    jos = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jopt.init({"lora": jax.tree.map(lambda a, i=i: a[i], jl), "head": jh[i]})
        for i in range(len(cuts))])
    jstep = j_splitfl.make_server_step_cls_batched(jm, jopt, impl="ragged")
    jloss, jnl, jnh, jno, jdv = jstep(jp, jl, jh, jos, jnp.asarray(v),
                                      {k: jnp.asarray(x) for k, x in batch.items()},
                                      np.asarray(cuts))

    tm = build_model(_cfg(impl), device="cpu")
    topt = AdamW(LR)
    tp, tl, th = to_torch(params, "cpu"), to_torch(lora_s, "cpu"), to_torch(heads, "cpu")
    tos = lora_lib.stack_trees([
        topt.init({"lora": lora_lib.unstack_tree(tl)[i], "head": th[i]})
        for i in range(len(cuts))])
    tstep = splitfl.make_server_step_cls_batched(tm, topt, impl="ragged")
    tloss, tnl, tnh, tno, tdv = tstep(tp, tl, th, tos, to_torch(v, "cpu"),
                                      to_torch(batch, "cpu"), list(cuts))

    assert _norm_err(tloss, jloss) <= 1e-5
    assert _norm_err(tdv, jdv) <= 1e-5
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_norm_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    assert tno.step.tolist() == np.asarray(jno.step).tolist() == [1] * len(cuts)
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)
    _close(tnh, jnh, atol=2 * LR, rtol=0)


def test_ragged_step_equals_the_sequential_steps(port):
    """Each lane of one ragged dispatch equals that client's own sequential
    server step (cuts out of order, a cut shared by two clients)."""
    tm, params, _, _ = port
    cuts = (2, 1, 3, 1)
    p_np, lora_s, heads, v, batch = _np_cohort(cuts, seed=4)
    tl, th, tv, tb = (to_torch(x, "cpu") for x in (lora_s, heads, v, batch))
    opt = AdamW(LR)
    states = [opt.init({"lora": lo, "head": th[i]})
              for i, lo in enumerate(lora_lib.unstack_tree(tl))]
    step = splitfl.make_server_step_cls_batched(tm, opt, impl="ragged")
    loss, nl, nh, no, dv = step(params, tl, th, lora_lib.stack_trees(states), tv, tb,
                                list(cuts))
    for i, cut in enumerate(cuts):
        seq = splitfl.make_server_step_cls(tm, opt, static_cut=cut)
        lane = lambda t, i=i: tree_map(lambda a: a[i], t)  # noqa: E731
        sl, snl, snh, sno, sdv = seq(params, lane(tl), th[i], states[i], tv[i], lane(tb))
        _close(loss[i], sl, atol=1e-6, rtol=0)
        _close(dv[i], sdv, atol=1e-6, rtol=0)
        _close_trees(lane(no.mu), sno.mu, atol=1e-7, rtol=0)
        _close_trees(lane(nl), snl, atol=2 * LR, rtol=0)
        _close(nh[i], snh, atol=2 * LR, rtol=0)


def test_stacked_adamw_update_equals_the_per_lane_update():
    """A stacked state at unequal steps: each lane of one update is exactly
    that client's own update."""
    rs = np.random.default_rng(2)
    opt = AdamW(LR)
    tree = lambda: {"a": torch.from_numpy(rs.standard_normal((3, 4)).astype(np.float32)),  # noqa: E731
                    "h": torch.from_numpy(rs.standard_normal(5).astype(np.float32))}
    params, grads = [tree() for _ in range(3)], [tree() for _ in range(3)]
    states = [opt.init(p) for p in params]
    for lane, n_steps in ((1, 1), (2, 7)):
        for _ in range(n_steps):
            states[lane] = opt.update(tree(), states[lane], params[lane])[1]
    new_p, new_s = opt.update(lora_lib.stack_trees(grads), lora_lib.stack_trees(states),
                              lora_lib.stack_trees(params))
    assert new_s.step.tolist() == [1, 2, 8]
    for i in range(3):
        want_p, want_s = opt.update(grads[i], states[i], params[i])
        got_p, got_s = lora_lib.unstack_tree(new_p)[i], lora_lib.unstack_tree(new_s)[i]
        for got, want in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
            assert torch.equal(got, want)


def test_batched_steps_outside_the_slice_raise(port):
    """Both impls of both batched steps are ported (the vmap and LM steps:
    tests/test_torch_scan.py, tests/test_torch_lm_train.py); an unknown
    impl still raises."""
    tm = port[0]
    for impl in ("vmap", "ragged"):
        assert callable(splitfl.make_server_step_cls_batched(tm, AdamW(LR), impl=impl))
        assert callable(splitfl.make_server_step_batched(tm, AdamW(LR), impl=impl))
    with pytest.raises(KeyError):
        splitfl.make_server_step_cls_batched(tm, AdamW(LR), impl="padded")


def test_ragged_chunking_splits_cut_groups_exactly(port):
    """cohort_chunk=1 serves each client of a cut group in its own
    dispatch (G = 1 groups): the same losses and dv as whole groups."""
    tm, params, _, _ = port
    cuts = (2, 1, 3, 1)
    _, lora_s, heads, v, batch = _np_cohort(cuts, seed=6)
    tl, th, tv, tb = (to_torch(x, "cpu") for x in (lora_s, heads, v, batch))
    opt = AdamW(LR)
    state = lora_lib.stack_trees([opt.init({"lora": lo, "head": th[i]})
                                  for i, lo in enumerate(lora_lib.unstack_tree(tl))])
    outs = [splitfl.make_server_step_cls_batched(tm, opt, cohort_chunk=chunk, impl="ragged")(
                params, tl, th, state, tv, tb, list(cuts)) for chunk in (None, 1)]
    assert [c for _, c in splitfl._ragged_chunks(np.asarray(cuts), 1)] == [1, 1, 2, 3]
    for whole, split in zip(outs[0][::4], outs[1][::4]):     # losses, dv
        _close(whole, split.detach().numpy(), atol=1e-6, rtol=0)
