"""The port's hybrid family (zamba2: a Mamba2 SSD stack with one shared
attention block after each segment) against the JAX package, from bridged
weights, in fp32: every Mamba2 function (``_causal_conv`` with and without
a history, ``ssd_scan``, ``ssd_chunked`` padded and from a non-zero state,
``_mamba_core``, the block's train / prefill / decode); then reduced
zamba2 at 5 layers with ``shared_attn_every=2`` (segments of 2, 2 and 1
layers: the last one short) — loss and logits on both paths (bit for bit
with each other), client and server sides at cuts 2 and 3 and at a per-row
cut, the prefill caches, decode against the parallel forward and against
the reference's decode, the adapter gradients (the shared block's
included) against ``jax.grad``, the LM server step, the full train step
and the cohort steps; the server-only adapter keys; and the bridge on a
bf16 model.

Tolerances: values normalised by their own scale within 2e-5 (fp32 sums
in another order, as tests/test_torch_families.py); decode against the
parallel forward at the reference's atol 2e-3
(tests/test_models_smoke.py); gradients at 1e-4 in the relative 2-norm;
adapters after AdamW at 2*lr per element and step (ROADMAP Queue C).
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

TOL = 2e-5
DECODE_ATOL = 2e-3
GRAD_TOL = 1e-4
LR = 1e-3
ARCH = "zamba2-7b"
N_LAYERS = 5
BATCH, SEQ = 2, 21          # SEQ not a multiple of wkv_chunk (16)


def _cfgs(impl="einsum", **kw):
    jc = j_reduced(J_REGISTRY[ARCH], n_layers=N_LAYERS).with_(**kw)
    tc = reduced(REGISTRY[ARCH], n_layers=N_LAYERS).with_(**kw)
    return (jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)),
            tc.with_(lora=dataclasses.replace(tc.lora, impl=impl)))


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x, np.float64)


def _err(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_err(got, want) -> float:
    if isinstance(got, dict):
        assert set(got) == set(want)
        return max(_tree_err(got[k], want[k]) for k in got)
    return _err(got, want)


def _rel2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _max_abs(got, want) -> float:
    if isinstance(got, dict):
        return max(_max_abs(got[k], want[k]) for k in got)
    return float(np.abs(_np(got) - _np(want)).max())


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return to_torch(tree, "cpu")


def _batch(cfg, rs, lead=(BATCH,), s=SEQ):
    return {"tokens": rs.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32),
            "targets": rs.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32)}


@pytest.fixture(scope="module")
def state():
    jc, _ = _cfgs()
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return params, lora, _batch(jc, rs)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------- the Mamba2 functions

@pytest.mark.parametrize("with_hist", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(with_hist, dtype):
    """The history is f32 (the cache's) and the input in the model's type:
    joined in f32, the output in x's type, the next history f32."""
    rs = np.random.default_rng(1)
    x = rs.standard_normal((2, 7, 24)).astype(np.float32)
    w = rs.standard_normal((4, 24)).astype(np.float32)
    b = rs.standard_normal(24).astype(np.float32)
    hist = rs.standard_normal((2, 3, 24)).astype(np.float32) if with_hist else None
    jx = jnp.asarray(x, dtype)
    jout, jhist = JB._causal_conv(jx, jnp.asarray(w), jnp.asarray(b),
                                  None if hist is None else jnp.asarray(hist))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tout, thist = B._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b),
                                 None if hist is None else torch.from_numpy(hist))
    assert str(tout.dtype) == f"torch.{jout.dtype}" and thist.dtype == torch.float32
    assert str(jhist.dtype) == "float32"
    np.testing.assert_array_equal(_np(thist), np.asarray(jhist, np.float64))
    assert _err(tout, np.asarray(jout, np.float32)) <= (TOL if dtype == "float32" else 1e-2)


def test_softplus_is_jax_softplus_past_the_threshold():
    """``F.softplus`` switches to x above 20; the port's form does not."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.5, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(_np(B._softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6)


def _ssd_inputs(s, seed=2, b=2, h=3, p=8, n=5, state=True):
    rs = np.random.default_rng(seed)
    xh = rs.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rs.standard_normal((b, s, n)).astype(np.float32)
    cm = rs.standard_normal((b, s, n)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    d_skip = rs.standard_normal(h).astype(np.float32)
    s0 = (rs.standard_normal((b, h, p, n)) if state else np.zeros((b, h, p, n))
          ).astype(np.float32)
    return xh, bm, cm, dt, a_log, d_skip, s0


def test_ssd_scan_matches_reference():
    args = _ssd_inputs(13)
    jy, js = JB.ssd_scan(*map(jnp.asarray, args))
    ty, ts = B.ssd_scan(*map(torch.from_numpy, args))
    assert _err(ty, jy) <= TOL and _err(ts, js) <= TOL


@pytest.mark.parametrize("s,chunk", [(21, 16), (37, 8), (16, 16), (1, 16)])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_chunked_matches_reference_and_scan(s, chunk, state):
    """S padded to a chunk multiple (21, 37, 1) or not (16), from a zero or
    a random state carried across chunks."""
    args = _ssd_inputs(s, seed=s, state=state)
    jy, js = JB.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = B.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert ty.shape == (2, s, 3, 8)
    assert _err(ty, jy) <= TOL and _err(ts, js) <= TOL
    sy, ss = B.ssd_scan(*map(torch.from_numpy, args))
    assert _err(ty, sy) <= TOL and _err(ts, ss) <= TOL


def _block_inputs(cfg, params, lora, seed=4, s=SEQ):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((BATCH, s, cfg.d_model)) * 0.5).astype(np.float32)
    return _layer(params["layers"], 1), _layer(lora["layers"], 1), x


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked"])
def test_mamba_core_matches_reference(state, wkv_impl):
    params, lora, _ = state
    jc, tc = _cfgs(wkv_impl=wkv_impl)
    p, lo, x = _block_inputs(jc, params, lora)
    rs = np.random.default_rng(5)
    d_in, nh, conv_ch = JB._mamba_dims(jc)
    hist = rs.standard_normal((BATCH, jc.ssm.d_conv - 1, conv_ch)).astype(np.float32)
    s0 = rs.standard_normal((BATCH, nh, jc.ssm.head_dim, jc.ssm.d_state)).astype(np.float32)
    for kw in ({}, {"conv_hist": hist, "state": s0}):
        jout = JB._mamba_core(jc, _jtree(p), _jtree(lo), jnp.asarray(x),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        tout = B._mamba_core(tc, _t(p), _t(lo), torch.from_numpy(x),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        for got, want in zip(tout, jout):
            assert _err(got, want) <= TOL


def test_mamba_block_train_prefill_decode_match_reference(state):
    params, lora, _ = state
    jc, tc = _cfgs(wkv_impl="chunked")
    p, lo, x = _block_inputs(jc, params, lora)
    jp, jlo, jx = _jtree(p), _jtree(lo), jnp.asarray(x)
    tp, tlo, tx = _t(p), _t(lo), torch.from_numpy(x)
    jy, _ = JB.mamba_train(jc, jp, jlo, jx, {})
    ty, taux = B.mamba_train(tc, tp, tlo, tx, {})
    assert _err(ty, jy) <= TOL and float(taux) == 0.0
    jy, jcache, _ = JB.mamba_prefill(jc, jp, jlo, jx, {})
    ty, tcache, _ = B.mamba_prefill(tc, tp, tlo, tx, {})
    assert _err(ty, jy) <= TOL and _tree_err(tcache, jcache) <= TOL
    # decode the next token from the prefill's cache, in place
    step = (np.random.default_rng(6).standard_normal((BATCH, 1, jc.d_model)) * 0.5
            ).astype(np.float32)
    jy, jnew = JB.mamba_decode(jc, jp, jlo, jnp.asarray(step), jcache, jnp.int32(SEQ), {})
    held = tcache["s"]
    ty, tnew = B.mamba_decode(tc, tp, tlo, torch.from_numpy(step), tcache, SEQ, {})
    assert tnew["s"] is held and tnew["conv"].dtype == torch.float32
    assert _err(ty, jy) <= TOL and _tree_err(tnew, jnew) <= TOL


# ---------------------------------------------------------------- the model

def test_segments_match_reference():
    jc, tc = _cfgs()
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    assert tm._segments() == jm._segments() == [(0, 2), (2, 4), (4, 5)]
    full = build_model(REGISTRY[ARCH], device="meta")
    assert full._segments() == j_build(J_REGISTRY[ARCH])._segments()
    assert len(full._segments()) == 14 and full._segments()[-1] == (78, 81)


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked"])
def test_loss_and_logits_match_reference(state, wkv_impl):
    """Full side on both paths: within TOL of the reference, and the sliced
    and scan paths bit for bit."""
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl=wkv_impl)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jloss, jlog = jm.loss(_jtree(params), _jtree(lora), _jtree(batch))
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    a_loss, a_log = tm.loss(tp, tl, tb)
    b_loss, b_log = tm.loss(tp, tl, tb, path="scan")
    assert _err(a_loss, jloss) <= TOL and _err(a_log, jlog) <= TOL
    assert torch.equal(a_loss, b_loss) and torch.equal(a_log, b_log)


def _split(params, lora, cut, jax_side):
    lib = j_lora if jax_side else lora_lib
    pc = dict(params)
    pc["layers"] = lib.slice_stack(params["layers"], 0, cut)
    lc, ls = lib.split_lora(lora, cut)
    spec = jax.eval_shape(lambda: lora) if jax_side else lora
    return pc, lc, lib.embed_in_full_shape(ls, spec, cut, "server")


@pytest.mark.parametrize("cut", [2, 3])
def test_client_and_server_sides_match_reference(state, cut):
    """Cut 2 ends a segment (the client runs the shared block after layer
    1), cut 3 falls inside one (the server runs it after layer 3).  The
    client on its truncated stack with its split adapters (the shared
    block's stay with the server, so the client's shared block runs
    without one, as the reference's does with its client part placed in a
    zero tree), and on the whole stack and adapters; both paths bit for
    bit."""
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    _, jlc, _ = _split(jp, jl, cut, True)
    tpc, tlc, _ = _split(tp, tl, cut, False)
    assert "shared" not in tlc
    # the reference's masked scan takes the whole stack: the client's part
    # placed in zeros (a zero adapter adds exactly nothing)
    jv, _ = jm.forward_hidden(jp, j_lora.embed_in_full_shape(
        jlc, jax.eval_shape(lambda: jl), cut, "client"), jb, cut=cut, side="client")
    tv, _ = tm.forward_hidden(tpc, tlc, tb, cut=cut, side="client")
    assert _err(tv, jv) <= TOL
    jw, _ = jm.forward_hidden(jp, jl, jb, cut=cut, side="client")
    tw, _ = tm.forward_hidden(tp, tl, tb, cut=cut, side="client")
    sw, _ = tm.forward_hidden(tp, tl, tb, cut=torch.tensor(cut), side="client",
                              path="scan")
    assert _err(tw, jw) <= TOL and _err(sw, jw) <= TOL
    assert torch.equal(tm.forward_hidden(tp, tl, tb, cut=cut, side="client",
                                         path="scan")[0], tw)
    jh, _ = jm.forward_hidden(jp, jl, jb, cut=cut, side="server", x0=jv)
    th, _ = tm.forward_hidden(tp, tl, tb, cut=cut, side="server", x0=tv)
    sh, _ = tm.forward_hidden(tp, tl, tb, cut=cut, side="server", x0=tv, path="scan")
    assert _err(th, jh) <= TOL and torch.equal(th, sh)


def test_per_row_cut_runs_each_row_at_its_own_cut(state):
    """One cut per batch row on the masked path (the vmap cohort step's
    form): each row equals the reference at that row's cut, client and
    server side, and the port's sliced path at that cut."""
    params, lora, _ = state
    jc, tc = _cfgs(wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    rs = np.random.default_rng(7)
    cuts = (2, 3, 5)          # on a segment boundary, inside one, every layer
    batch = _batch(jc, rs, lead=(len(cuts),))
    x0 = (rs.standard_normal((len(cuts), SEQ, jc.d_model)) * 0.5).astype(np.float32)
    jp, jl = _jtree(params), _jtree(lora)
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    row_cut = torch.tensor(cuts)
    client, _ = tm.forward_hidden(tp, tl, tb, cut=row_cut, side="client", path="scan")
    server, _ = tm.forward_hidden(tp, tl, tb, cut=row_cut, side="server", path="scan",
                                  x0=torch.from_numpy(x0))
    for i, c in enumerate(cuts):
        row = {k: v[i:i + 1] for k, v in batch.items()}
        jv, _ = jm.forward_hidden(jp, jl, _jtree(row), cut=c, side="client")
        jh, _ = jm.forward_hidden(jp, jl, _jtree(row), cut=c, side="server",
                                  x0=jnp.asarray(x0[i:i + 1]))
        assert _err(client[i:i + 1], jv) <= TOL and _err(server[i:i + 1], jh) <= TOL
        tv, _ = tm.forward_hidden(tp, tl, _t(row), cut=c, side="client")
        assert _err(client[i:i + 1], tv) <= 1e-6


def test_prefill_caches_match_reference(state):
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    pre = {"tokens": batch["tokens"]}
    jlog, jcache = jm.prefill(_jtree(params), _jtree(lora), _jtree(pre))
    tlog, tcache = tm.prefill(_t(params), _t(lora), _t(pre))
    assert set(tcache) == {"mamba", "attn"}
    assert tcache["attn"]["k"].shape[0] == 3 and tcache["mamba"]["s"].shape[0] == N_LAYERS
    assert _err(tlog, jlog) <= TOL and _tree_err(tcache, jcache) <= TOL
    spec = tm.cache_spec(BATCH, SEQ)
    assert all(s.shape == c.shape and s.dtype == c.dtype and s.device.type == "meta"
               for s, c in zip(tree_leaves(spec), tree_leaves(tcache)))


@pytest.mark.parametrize("wkv_impl", ["scan", "chunked"])
def test_decode_matches_parallel_forward_and_reference(state, wkv_impl):
    """Token by token from an empty cache (written in place): the logits
    of the teacher-forced forward at the reference's atol, and (under
    "chunked", which the reference's decode runs as one padded chunk) the
    reference's decode within TOL."""
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl=wkv_impl)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    seq = 9
    toks = batch["tokens"][:, :seq]
    tp, tl = _t(params), _t(lora)
    _, full = tm.loss(tp, tl, _t({"tokens": toks, "targets": toks}))
    cache = tm.init_cache(BATCH, seq)
    jcache = jm.init_cache(BATCH, seq)
    outs = []
    for i in range(seq):
        lg, cache2 = tm.serve_step(tp, tl, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert cache2 is cache
        if wkv_impl == "chunked":
            jlg, jcache = jm.serve_step(_jtree(params), _jtree(lora), jcache,
                                        jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            assert _err(lg, jlg) <= TOL
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full), atol=DECODE_ATOL)
    if wkv_impl == "chunked":
        assert _tree_err(cache, jcache) <= TOL


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_adapter_grads_match_jax_grad(state, impl):
    """Every adapter leaf's gradient, the shared block's included, on the
    scan path (full side)."""
    params, lora, batch = state
    jc, tc = _cfgs(impl, wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")

    def jloss(lo):
        return jm.loss(_jtree(params), lo, _jtree(batch))[0]

    jg = jax.tree_util.tree_flatten_with_path(jax.grad(jloss)(_jtree(lora)))[0]
    tl = tree_map(lambda a: a.requires_grad_(True), _t(lora))
    tloss, _ = tm.loss(_t(params), tl, _t(batch), path="scan")
    assert _err(tloss, jloss(_jtree(lora))) <= TOL
    flat = jax.tree_util.tree_flatten_with_path(tl)[0]   # torch leaves, by key path
    got = dict(zip([p for p, _ in flat], torch.autograd.grad(tloss, [t for _, t in flat])))
    assert len(got) == len(jg)
    assert any("shared" in jax.tree_util.keystr(p) for p, _ in jg)
    for path, want in jg:
        assert _rel2(got[path], want) <= GRAD_TOL, jax.tree_util.keystr(path)


# ---------------------------------------------------------------- split steps

@pytest.mark.parametrize("remat", [False, True])
def test_full_train_step_matches_reference(state, remat):
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    jstep = j_splitfl.make_full_train_step(jm, jopt, remat=remat, donate=False)
    tstep = splitfl.make_full_train_step(tm, topt, remat=remat)
    jl, tl = _jtree(lora), _t(lora)
    js, ts = jopt.init(jl), topt.init(tl)
    jp, tp = _jtree(params), _t(params)
    rs = np.random.default_rng(11)
    for i in range(2):
        b = batch if i == 0 else _batch(jc, rs)
        jloss, jl, js = jstep(jp, jl, js, _jtree(b))
        tloss, tl, ts = tstep(tp, tl, ts, _t(b))
        assert _err(tloss, jloss) <= TOL
        assert _max_abs(tl, jl) <= 2 * LR * (i + 1)


def test_full_step_remat_is_bit_for_bit():
    jc, tc = _cfgs(wkv_impl="chunked")
    tm = build_model(tc, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params, lora = tm.init_params(gen), tm.init_lora(gen)
    batch = _t(_batch(jc, np.random.default_rng(12)))
    opt = AdamW(LR)
    outs = [splitfl.make_full_train_step(tm, opt, remat=r)(params, lora, opt.init(lora), batch)
            for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0][1]),
                                                 tree_leaves(outs[1][1])))


@pytest.mark.parametrize("path", ["sliced", "scan"])
@pytest.mark.parametrize("cut", [2, 3])
def test_lm_server_step_matches_reference(state, path, cut):
    params, lora, batch = state
    jc, tc = _cfgs(wkv_impl="chunked")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    jpc, jlc, jls = _split(jp, jl, cut, True)
    tpc, tlc, tls = _split(tp, tl, cut, False)
    jv = j_splitfl.client_forward(jm, jpc, jlc, jb, cut)
    tv = splitfl.client_forward(tm, tpc, tlc, tb, cut)
    assert _err(tv, jv) <= TOL
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
    assert _err(tloss, jloss) <= TOL and _err(tdv, jdv) <= TOL
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    assert _max_abs(tnl, jnl) <= 2 * LR


def test_sliced_and_scan_server_steps_are_bit_for_bit(state):
    params, lora, batch = state
    _, tc = _cfgs(wkv_impl="chunked")
    tm = build_model(tc, device="cpu")
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    opt = AdamW(LR)
    v = torch.from_numpy((np.random.default_rng(8).standard_normal(
        (BATCH, SEQ, tc.d_model)) * 0.5).astype(np.float32))
    for cut in range(N_LAYERS + 1):
        a = splitfl.make_server_step(tm, opt, static_cut=cut)(tp, tl, opt.init(tl), v, tb)
        b = splitfl.make_server_step(tm, opt, path="scan")(tp, tl, opt.init(tl), v, tb, cut)
        assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))


COHORT_B = 2
COHORT_CUTS = (1, N_LAYERS, 2, 3)


def _np_cohort(params, lora, cuts, seed=1):
    """Per-lane server adapters (zeros below the lane's cut, the shared
    block's whole), activations and batches, stacked on a cohort axis."""
    rs = np.random.default_rng(seed)

    def rand(a):
        return (rs.standard_normal(a.shape) * 0.05).astype(np.float32)

    def server_part(cut):
        return {"layers": jax.tree.map(lambda a: np.concatenate(
                    [np.zeros_like(a[:cut]), rand(a[cut:])]), lora["layers"]),
                "shared": jax.tree.map(rand, lora["shared"])}

    lora_s = jax.tree.map(lambda *xs: np.stack(xs), *[server_part(c) for c in cuts])
    d, vocab = params["embed"].shape[1], params["embed"].shape[0]
    v = (rs.standard_normal((len(cuts), COHORT_B, SEQ, d)) * 0.5).astype(np.float32)
    batch = {"tokens": rs.integers(0, vocab, (len(cuts), COHORT_B, SEQ)).astype(np.int32),
             "targets": rs.integers(0, vocab, (len(cuts), COHORT_B, SEQ)).astype(np.int32)}
    return lora_s, v, batch


@pytest.mark.parametrize("impl,chunk", [("vmap", 2), ("vmap", None), ("ragged", None)])
def test_lm_cohort_step_matches_reference(state, impl, chunk):
    """Per-lane losses, dv and gradients (from the first moment) to 1e-5 of
    their scale, adapters after AdamW to 2*lr; the shared block's adapters
    stay cohort-grouped."""
    params, lora, _ = state
    jc, tc = _cfgs(wkv_impl="chunked")
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
    tl = _t(lora_s)
    tos = lora_lib.stack_trees([topt.init(lo) for lo in lora_lib.unstack_tree(tl)])
    tstep = splitfl.make_server_step_batched(tm, topt, cohort_chunk=chunk, impl=impl)
    tloss, tnl, tno, tdv = tstep(_t(params), tl, tos, _t(v), _t(batch), list(COHORT_CUTS))
    assert _err(tloss, jloss) <= 1e-5 and _err(tdv, jdv) <= 1e-5
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    assert _max_abs(tnl, jnl) <= 2 * LR


# ---------------------------------------------------------------- the port's own rules

def test_server_only_keys_stay_with_the_server():
    """The shared block's adapters (and the encoder-decoder's decoder) are
    never split at the cut: the client part has none, the server part all,
    as in the reference."""
    assert lora_lib.SERVER_ONLY_KEYS == j_lora.SERVER_ONLY_KEYS == ("shared", "dec_layers")
    assert lora_lib.STACKED_KEYS == j_lora.STACKED_KEYS
    _, tc = _cfgs()
    lora = build_model(tc, device="cpu").init_lora(torch.Generator().manual_seed(0))
    client, server = lora_lib.split_lora(lora, 2)
    assert set(client) == {"layers"} and server["shared"] is lora["shared"]
    full = lora_lib.assemble_full(client, server, 2)
    assert full["shared"] is lora["shared"]
    placed = lora_lib.embed_in_full_shape(server, lora, 2, "server")
    assert placed["shared"] is lora["shared"]


def test_bridge_carries_a_bf16_hybrid_model():
    """bf16 projections and embeddings bit for bit; the conv, decay, skip
    and dt-bias leaves, the norms and the adapters stay f32, as the port's
    own init makes them."""
    jc = j_reduced(J_REGISTRY[ARCH], n_layers=3).with_(dtype="bfloat16")
    tc = reduced(REGISTRY[ARCH], n_layers=3).with_(dtype="bfloat16")
    jm = j_build(jc)
    np_params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    bridged = _t(np_params)
    own = build_model(tc, device="cpu").init_params(torch.Generator().manual_seed(0))
    j_flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    b_flat = dict(jax.tree_util.tree_flatten_with_path(bridged)[0])
    o_flat = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert len(j_flat) == len(b_flat) == len(o_flat)
    for path, want in j_flat:
        got, name = b_flat[path], str(want.dtype)
        assert str(got.dtype) == f"torch.{name}" == str(o_flat[path].dtype), path
        assert tuple(got.shape) == want.shape == tuple(o_flat[path].shape), path
        if name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    for key in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias"):
        assert bridged["layers"][key].dtype == torch.float32
    assert bridged["layers"]["in_proj"].dtype == torch.bfloat16
    assert bridged["shared"]["attn"]["wq"].dtype == torch.bfloat16
