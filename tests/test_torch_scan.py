"""The masked-scan path in the port and the vmap cohort classification
step, against the JAX package's, from bridged weights and numpy-seeded
inputs.

* ``DecoderModel.forward_hidden(path="scan")`` on reduced bert-base,
  gemma-2b (3 layers) and rwkv6-3b (2 layers), fp32: against the port's sliced path
  at every cut and side, against the reference's ``path="scan"``, with an
  int cut and with one cut per row (held row by row against the
  reference's scan at that row's cut), and its adapter gradients with
  ``remat`` on and off against the reference's ``jax.grad`` through its
  (checkpointed) scan.
* ``make_server_step_cls_batched(impl="vmap")`` against the reference's
  vmapped step at heterogeneous cuts, ``cohort_chunk`` 1, 2 and None,
  einsum and fused (the reference's Pallas kernel in interpret mode); and
  against the port's ragged step and its sequential steps.

Tolerances: values before the optimizer step (hidden states, losses,
logits, dv, gradients) at rtol 1e-4 / atol 1e-5 — fp32 sums in another
order — or, normalised by the tensor's own scale, 1e-5; the masked scan
against the port's sliced path bit for bit (the same operations on the
same rows).  Adapters and heads after one AdamW step at atol 2*lr per
element: on the first step m/sqrt(v) is about +-1, so an element whose
gradient is near zero may move by lr the other way under any reordering
of its sum (ROADMAP Queue C).
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
from repro.core import splitfl as j_splitfl  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.core import splitfl  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

set_fp32_policy()

RTOL, ATOL = 1e-4, 1e-5
LR = 1e-3
# rwkv6-3b at 2 layers, as in tests/test_torch_lm.py: the stack amplifies
# rounding about 3x a layer, so at 1e-5 it is held at 2 layers here and at
# 4 layers by the rwkv6 depth tests below, against its own conditioning
N_LAYERS = {"bert-base": 3, "gemma-2b": 3, "rwkv6-3b": 2}
ARCHS = list(N_LAYERS)
BATCH, SEQ = 4, 12


def _cfgs(arch, impl="einsum"):
    kw = dict(n_layers=N_LAYERS[arch])
    if arch == "bert-base":
        kw["d_model"] = 128
    jc, tc = j_reduced(J_REGISTRY[arch], **kw), reduced(REGISTRY[arch], **kw)
    return (jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)),
            tc.with_(lora=dataclasses.replace(tc.lora, impl=impl)))


def _batch(cfg, rs, lead=(BATCH,)):
    toks = rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)
    if cfg.n_classes:
        return {"tokens": toks, "label": rs.integers(0, cfg.n_classes, lead).astype(np.int32)}
    return {"tokens": toks,
            "targets": rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)}


@pytest.fixture(scope="module", params=ARCHS)
def state(request):
    arch = request.param
    jc, _ = _cfgs(arch)
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return arch, params, lora, _batch(jc, rs)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _close_trees(got, want, **kw):
    """Leaf by leaf, matched by key path (JAX returns dicts key-sorted)."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close_trees(got[k], want[k], **kw)
    else:
        _close(got, want, **kw)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x0(cfg, rs, rows=BATCH):
    return (rs.standard_normal((rows, SEQ, cfg.d_model)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("side", ["client", "server", "full"])
def test_scan_equals_sliced_at_every_cut(state, side):
    arch, params, lora, batch = state
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    x0 = None if side == "client" or side == "full" else \
        torch.from_numpy(_x0(tc, np.random.default_rng(1)))
    with torch.no_grad():
        for cut in range(N_LAYERS[arch] + 1):
            hs, _ = tm.forward_hidden(tp, tl, tb, cut=cut, side=side, path="sliced", x0=x0)
            for c in (cut, torch.tensor(cut)):
                hm, aux = tm.forward_hidden(tp, tl, tb, cut=c, side=side, path="scan",
                                            x0=x0)
                assert torch.equal(hm, hs) and float(aux) == 0.0
            per_row = torch.full((BATCH,), cut)
            hr, aux = tm.forward_hidden(tp, tl, tb, cut=per_row, side=side, path="scan",
                                        x0=x0)
            # side "full" ignores the cut, so its aux loss stays one number
            assert torch.equal(hr, hs)
            assert aux.shape == (() if side == "full" else (BATCH,))


@pytest.mark.parametrize("side", ["client", "server", "full"])
def test_scan_matches_reference(state, side):
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    x0 = _x0(tc, np.random.default_rng(2)) if side == "server" else None
    jx0 = None if x0 is None else jnp.asarray(x0)
    tx0 = None if x0 is None else torch.from_numpy(x0)
    for cut in (0, 1, N_LAYERS[arch]):
        jh, _ = jm.forward_hidden(_jtree(params), _jtree(lora), _jtree(batch),
                                  cut=jnp.int32(cut), side=side, path="scan", x0=jx0)
        jl, jlog = jm.loss(_jtree(params), _jtree(lora), _jtree(batch),
                           cut=jnp.int32(cut), side=side, path="scan", x0=jx0)
        with torch.no_grad():
            th, _ = tm.forward_hidden(tp, tl, tb, cut=torch.tensor(cut), side=side,
                                      path="scan", x0=tx0)
            tl_, tlog = tm.loss(tp, tl, tb, cut=cut, side=side, path="scan", x0=tx0)
        _close(th, jh)
        _close(tlog, jlog)
        _close(tl_, jl)


def test_per_row_cuts_match_reference_row_by_row(state):
    """One cut per row (the vmap step's form) equals, row by row, the
    reference's masked scan of that row alone at its cut."""
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    x0 = _x0(tc, np.random.default_rng(3))
    cuts = [min(c, N_LAYERS[arch]) for c in (2, 0, 3, 1)]
    with torch.no_grad():
        th, _ = tm.forward_hidden(to_torch(params, "cpu"), to_torch(lora, "cpu"),
                                  to_torch(batch, "cpu"), cut=torch.tensor(cuts),
                                  side="server", path="scan", x0=torch.from_numpy(x0))
    for row, cut in enumerate(cuts):
        rb = {k: v[row:row + 1] for k, v in batch.items()}
        jh, _ = jm.forward_hidden(_jtree(params), _jtree(lora), _jtree(rb),
                                  cut=jnp.int32(cut), side="server", path="scan",
                                  x0=jnp.asarray(x0[row:row + 1]))
        _close(th[row:row + 1], jh)


@pytest.mark.parametrize("remat", [False, True])
def test_scan_gradients_match_reference(state, remat):
    """Adapter gradients of the full loss and of the server loss at cut 1
    through the masked loop, ``remat`` on (each layer recomputed in the
    backward) and off, against the reference's."""
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    x0 = _x0(tc, np.random.default_rng(4))
    tp, tb = to_torch(params, "cpu"), to_torch(batch, "cpu")
    for side, cut, xx in (("full", 0, None), ("server", 1, x0)):
        jg = jax.grad(lambda lo: jm.loss(_jtree(params), lo, _jtree(batch), cut=cut,
                                         side=side, path="scan", remat=remat,
                                         x0=None if xx is None else jnp.asarray(xx))[0]
                      )(_jtree(lora))
        leaf = splitfl.as_trainable(to_torch(lora, "cpu"))
        with torch.enable_grad():
            loss, _ = tm.loss(tp, leaf, tb, cut=cut, side=side, path="scan", remat=remat,
                              x0=None if xx is None else torch.from_numpy(xx))
            tg = splitfl.tree_grad(loss, leaf)[0]
        _close_trees(tg, jg)
        if side == "server":    # no gradient reaches the client's layers
            client_g, _ = lora_lib.split_lora(tg, cut)
            assert all(float(np.abs(x).max()) == 0.0 for x in
                       jax.tree.leaves(tree_map(lambda t: t.numpy(), client_g)))


def test_remat_changes_no_value(state):
    arch, params, lora, batch = state
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    tp, tb = to_torch(params, "cpu"), to_torch(batch, "cpu")
    out = []
    for remat in (False, True):
        leaf = splitfl.as_trainable(to_torch(lora, "cpu"))
        with torch.enable_grad():
            loss, _ = tm.loss(tp, leaf, tb, path="scan", remat=remat)
            out.append((loss.detach(), splitfl.tree_grad(loss, leaf)[0]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), out[0][1])),
                    jax.tree.leaves(tree_map(lambda t: t.numpy(), out[1][1]))):
        np.testing.assert_array_equal(a, b)


def test_unknown_path_raises(state):
    arch, params, lora, batch = state
    tm = build_model(_cfgs(arch)[1], device="cpu")
    with pytest.raises(KeyError, match="path"):
        tm.forward_hidden(to_torch(params, "cpu"), to_torch(lora, "cpu"),
                          to_torch(batch, "cpu"), path="masked")


# ---------------------------------------------------------------- rwkv6-3b with depth
#
# ROADMAP Queue C.4: at depth the port's rwkv6-3b hidden state drifts from
# the reference's, about 4x a layer.  These two tests hold it at 4 layers:
# every operation of every layer's block equals the reference's on the same
# inputs, and the whole-depth gap stays within a small factor of what the
# stack does to a rounding-sized change of its own input.

RWKV_DEPTH = 4
RWKV_OP_TOL = 1e-5       # each operation, by its output's own scale
RWKV_COND_FACTOR = 10.0  # whole depth, over the reference's own sensitivity


@pytest.fixture(scope="module")
def rwkv_deep():
    jc = j_reduced(J_REGISTRY["rwkv6-3b"], n_layers=RWKV_DEPTH)
    tc = reduced(REGISTRY["rwkv6-3b"], n_layers=RWKV_DEPTH)
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return jc, tc, jm, params, lora, _batch(jc, rs)


def _scaled_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_rwkv6_block_operations_match_reference_at_every_layer(rwkv_deep):
    """Each operation of the RWKV6 block (the norms, the ddlerp, the time-mix
    projections with the decay exp(-exp(w)), the WKV recurrence, the group
    norm and output projection, the channel mix) on the reference's own
    inputs to it, at every layer of 4."""
    from repro.models import blocks as JB
    from repro.models import layers as JL
    from repro_torch.models import blocks as TB
    from repro_torch.models import layers as TL
    jc, tc, jm, params, lora, batch = rwkv_deep
    errs = {}

    def check(name, got, want):
        errs[name] = max(errs.get(name, 0.0), _scaled_err(got, want))

    t = _t
    x = np.asarray(jm.embed(_jtree(params), _jtree(batch)))
    with torch.no_grad():
        for layer in range(RWKV_DEPTH):
            p = jax.tree.map(lambda a: a[layer], params["layers"])
            lo = jax.tree.map(lambda a: a[layer], lora["layers"])
            jp, jlo, tp, tlo = _jtree(p), _jtree(lo), to_torch(p, "cpu"), to_torch(lo, "cpu")
            hx = JL.apply_norm(jc, jp["tm"]["ln"], jnp.asarray(x))
            check("ln_tm", TL.apply_norm(tc, tp["tm"]["ln"], t(x)), hx)
            hx = np.asarray(hx)
            jprev, tprev = JB._shift(jnp.asarray(hx)), TB._shift(t(hx))
            for g, w in zip(TB._ddlerp(tp["tm"], t(hx), tprev),
                            JB._ddlerp(jp["tm"], jnp.asarray(hx), jprev)):
                check("ddlerp", g, w)
            jproj = JB._tm_projections(jc, jp["tm"], jlo["tm"], jnp.asarray(hx), jprev)
            tproj = TB._tm_projections(tc, tp["tm"], tlo["tm"], t(hx), tprev)
            for name, g, w in zip(("r", "k", "v", "decay", "g"), tproj, jproj):
                check(name, g, w)
            r, k, v, decay, gate = (np.asarray(a) for a in jproj)
            b, s, h, dh = r.shape
            jw, _ = JB.wkv_apply(jc, *map(jnp.asarray, (r, k, v, decay)), jp["tm"]["u"],
                                 jnp.zeros((b, h, dh, dh), jnp.float32))
            check("wkv", TB.wkv_apply(tc, *map(t, (r, k, v, decay)), tp["tm"]["u"])[0], jw)
            jw = np.asarray(jw)
            jo = JB._tm_out(jc, jp["tm"], jlo["tm"], jnp.asarray(jw).astype(x.dtype),
                            jnp.asarray(gate))
            check("tm_out", TB._tm_out(tc, tp["tm"], tlo["tm"], t(jw), t(gate)), jo)
            x1 = x + np.asarray(jo)
            hx = JL.apply_norm(jc, jp["cm"]["ln"], jnp.asarray(x1))
            check("ln_cm", TL.apply_norm(tc, tp["cm"]["ln"], t(x1)), hx)
            hx = np.asarray(hx)
            jcm = JB._cm_apply(jc, jp["cm"], jlo["cm"], jnp.asarray(hx),
                               JB._shift(jnp.asarray(hx)))
            check("cm", TB._cm_apply(tc, tp["cm"], tlo["cm"], t(hx), TB._shift(t(hx))), jcm)
            x, _ = JB.rwkv_train(jc, jp, jlo, jnp.asarray(x), {})
            x = np.asarray(x)
    assert max(errs.values()) <= RWKV_OP_TOL, errs


def test_rwkv6_depth_gap_is_within_the_stacks_conditioning(rwkv_deep):
    """The port's hidden state after each of 4 layers against the
    reference's, held against the reference's own sensitivity: how far its
    output moves when its embedding moves by 1e-7 of each element (about
    one fp32 rounding).  The gap may be a few times that, since every
    operation rounds in its own order; a wrong operation would show as a
    gap far above it from the first layer on."""
    jc, tc, jm, params, lora, batch = rwkv_deep
    tm = build_model(tc, device="cpu")
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    x0 = np.asarray(jm.embed(jp, jb))
    noise = np.random.default_rng(5).standard_normal(x0.shape).astype(np.float32)
    x0_moved = x0 * (1 + 1e-7 * noise)
    with torch.no_grad():
        for cut in range(1, RWKV_DEPTH + 1):
            jh, _ = jm.forward_hidden(jp, jl, jb, cut=cut, side="client", path="sliced",
                                      x0=jnp.asarray(x0))
            jh_moved, _ = jm.forward_hidden(jp, jl, jb, cut=cut, side="client",
                                            path="sliced", x0=jnp.asarray(x0_moved))
            th, _ = tm.forward_hidden(tp, tl, tb, cut=cut, side="client", x0=_t(x0))
            sensitivity = _scaled_err(jh_moved, jh)
            assert _scaled_err(th, jh) <= RWKV_COND_FACTOR * sensitivity, (
                cut, _scaled_err(th, jh), sensitivity)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- the vmap cohort step

COHORT_B = 2
CUTS = (1, 3, 2, 1)


def _np_cohort(cuts, seed=1):
    """Per-client numpy state for a cohort of reduced bert-base: full-shape
    server adapters (zero below each client's cut, as the Simulator embeds
    them), heads, received activations and batches, stacked on a lane axis."""
    jc, _ = _cfgs("bert-base")
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(seed)
    g = len(cuts)

    def server_part(cut):
        return jax.tree.map(lambda a: np.concatenate(
            [np.zeros_like(a[:cut]), (rs.standard_normal(a[cut:].shape) * 0.05)
             .astype(np.float32)]), lora)

    lora_s = jax.tree.map(lambda *xs: np.stack(xs), *[server_part(c) for c in cuts])
    heads = (rs.standard_normal((g,) + params["cls_head"].shape) * 0.1).astype(np.float32)
    v = rs.standard_normal((g, COHORT_B, SEQ, jc.d_model)).astype(np.float32)
    return params, lora_s, heads, v, _batch(jc, rs, lead=(g, COHORT_B))


def _norm_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_norm_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_tree_norm_err(got[k], want[k]) for k in got)
    return _norm_err(got, want)


def _torch_cohort(cuts, opt, seed=1):
    params, lora_s, heads, v, batch = _np_cohort(cuts, seed)
    tl, th = to_torch(lora_s, "cpu"), to_torch(heads, "cpu")
    tos = lora_lib.stack_trees([opt.init({"lora": lo, "head": th[i]})
                                for i, lo in enumerate(lora_lib.unstack_tree(tl))])
    return (to_torch(params, "cpu"), tl, th, tos, to_torch(v, "cpu"),
            to_torch(batch, "cpu"))


@pytest.mark.parametrize("impl", ["einsum", "fused"])
@pytest.mark.parametrize("chunk", [1, 2, None])
def test_vmap_cls_step_matches_reference(impl, chunk):
    """Losses, dv and the adapter and head gradients (read from the first
    moment, mu = (1 - b1) g after one step) to 1e-5 of their scale;
    adapters and heads after the AdamW step to 2*lr."""
    params, lora_s, heads, v, batch = _np_cohort(CUTS)
    jc, tc = _cfgs("bert-base", impl)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    jl, jh = _jtree(lora_s), jnp.asarray(heads)
    jos = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jopt.init({"lora": jax.tree.map(lambda a, i=i: a[i], jl), "head": jh[i]})
        for i in range(len(CUTS))])
    jstep = j_splitfl.make_server_step_cls_batched(jm, jopt, cohort_chunk=chunk,
                                                   impl="vmap")
    jloss, jnl, jnh, jno, jdv = jstep(_jtree(params), jl, jh, jos, jnp.asarray(v),
                                      _jtree(batch), jnp.asarray(CUTS))

    tstep = splitfl.make_server_step_cls_batched(tm, topt, cohort_chunk=chunk,
                                                 impl="vmap")
    tloss, tnl, tnh, tno, tdv = tstep(*_torch_cohort(CUTS, topt), list(CUTS))

    assert _norm_err(tloss, jloss) <= 1e-5
    assert _norm_err(tdv, jdv) <= 1e-5
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_norm_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    assert tno.step.tolist() == np.asarray(jno.step).tolist() == [1] * len(CUTS)
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)
    _close(tnh, jnh, atol=2 * LR, rtol=0)


def test_vmap_step_equals_ragged_and_sequential_steps():
    """Each lane of the vmap step equals the ragged step's lane and that
    client's own sequential server step; cuts given as a tensor."""
    opt = AdamW(LR)
    tm = build_model(_cfgs("bert-base")[1], device="cpu")
    args = _torch_cohort(CUTS, opt, seed=4)
    tp, tl, th, tos, tv, tb = args
    vm = splitfl.make_server_step_cls_batched(tm, opt, impl="vmap")(*args,
                                                                    torch.tensor(CUTS))
    rg = splitfl.make_server_step_cls_batched(tm, opt, impl="ragged")(*args, list(CUTS))
    for i, cut in enumerate(CUTS):
        seq = splitfl.make_server_step_cls(tm, opt, static_cut=cut)
        lane = lambda t, i=i: tree_map(lambda a: a[i], t)  # noqa: E731
        sl, snl, snh, sno, sdv = seq(tp, lane(tl), th[i], lane(tos), tv[i], lane(tb))
        for out in (vm, rg):
            _close(out[0][i], sl, atol=1e-6, rtol=0)
            _close(out[4][i], sdv, atol=1e-6, rtol=0)
            _close_trees(lane(out[3].mu), sno.mu, atol=1e-7, rtol=0)
            _close_trees(lane(out[1]), snl, atol=2 * LR, rtol=0)
            _close(out[2][i], snh, atol=2 * LR, rtol=0)


def test_vmap_chunks_run_in_cohort_order():
    """cohort_chunk splits the cohort in order, whatever the cuts (the
    ragged step groups by cut instead): the same results whole and split."""
    opt = AdamW(LR)
    tm = build_model(_cfgs("bert-base")[1], device="cpu")
    args = _torch_cohort(CUTS, opt, seed=6)
    assert splitfl._chunk_slices(4, 3) == [slice(0, 3), slice(3, 4)]
    outs = [splitfl.make_server_step_cls_batched(tm, opt, cohort_chunk=chunk,
                                                 impl="vmap")(*args, list(CUTS))
            for chunk in (None, 3, 1)]
    for other in outs[1:]:
        _close(other[0], outs[0][0].numpy(), atol=1e-6, rtol=0)
        _close(other[4], outs[0][4].numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="one per lane"):
        splitfl.make_server_step_cls_batched(tm, opt, impl="vmap")(*args, [1, 2])
