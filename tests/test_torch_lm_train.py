"""LM split training in the port against the JAX package's, from bridged
weights and numpy-seeded inputs: the optimizer (AdamW with weight decay,
gradient clipping and the learning-rate schedules), the ``core/lora.py``
helpers, and on reduced gemma-2b (3 layers) and rwkv6-3b (2 layers, as
tests/test_torch_scan.py explains) in fp32: ``client_forward_with_vjp``,
the LM ``make_server_step`` on the sliced and the scan path,
``make_full_train_step`` with ``remat`` on and off, and the LM cohort
step ``make_server_step_batched`` in its vmap and ragged forms at
heterogeneous cuts; last, ``python -m repro_torch.launch.train`` in its
two modes on the CPU.

Tolerances: values before the optimizer step (v, losses, logits, dv,
gradients) at rtol 1e-4 / atol 2e-5, the LM tolerance of
tests/test_torch_lm.py — fp32 sums in another order — or, normalised by
the tensor's own scale, 1e-5.  Adapters after AdamW at atol 2*lr per
element and step (ROADMAP Queue C: an element whose gradient is near zero
may move by lr the other way under any reordering of its sum).  The
optimizer on equal gradients: parameters at rtol 1e-6 (elementwise f32
operations; the clip norm's sum and the schedule's cosine may round
differently from XLA's); a stacked update against its lanes' own updates
bit for bit.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

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
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import schedules as j_schedules  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.core import splitfl  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.optim import AdamW, schedules  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

set_fp32_policy()

RTOL, ATOL = 1e-4, 2e-5
LR = 1e-3
N_LAYERS = {"gemma-2b": 3, "rwkv6-3b": 2}
ARCHS = list(N_LAYERS)
BATCH, SEQ = 2, 12
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if torch.is_tensor(got)
                                          else got, np.float32),
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


def _norm_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_norm_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_tree_norm_err(got[k], want[k]) for k in got)
    return _norm_err(got, want)


# ---------------------------------------------------------------- the optimizer

def _grad_seq(seed, n=4):
    rs = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": {"v": (7,)}}
    mk = lambda: {"w": rs.standard_normal(shapes["w"]).astype(np.float32),  # noqa: E731
                  "b": {"v": (rs.standard_normal(shapes["b"]["v"]) * 3).astype(np.float32)}}
    return mk(), [mk() for _ in range(n)]


SCHEDULES = {
    "constant": lambda m: m.constant(LR),
    "warmup_cosine": lambda m: m.linear_warmup_cosine(LR, 2, 5, 0.2),
    "inverse_sqrt": lambda m: m.inverse_sqrt(LR, 3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    jf, tf = SCHEDULES[name](j_schedules), SCHEDULES[name](schedules)
    for step in range(9):
        want = float(jf(jnp.int32(step)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("lr", ["float", *SCHEDULES])
@pytest.mark.parametrize("decay,clip", [(0.0, None), (0.01, None), (0.0, 1.5), (0.05, 0.5)])
def test_adamw_matches_reference_step_by_step(lr, decay, clip):
    params, grads = _grad_seq(0)
    jlr = LR if lr == "float" else SCHEDULES[lr](j_schedules)
    tlr = LR if lr == "float" else SCHEDULES[lr](schedules)
    jopt = JAdamW(jlr, weight_decay=decay, grad_clip_norm=clip)
    topt = AdamW(tlr, weight_decay=decay, grad_clip_norm=clip)
    jp, tp = _jtree(params), to_torch(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(_jtree(g), js, jp)
        tp, ts = topt.update(to_torch(g, "cpu"), ts, tp)
        _close_trees(tp, jp, rtol=1e-6, atol=1e-9)
        _close_trees(ts.mu, js.mu, rtol=1e-6, atol=1e-9)
        _close_trees(ts.nu, js.nu, rtol=1e-6, atol=1e-9)
        assert int(ts.step) == int(js.step)


@pytest.mark.parametrize("lr", ["float", "warmup_cosine"])
def test_stacked_update_clips_each_lane_by_its_own_norm(lr):
    """A stacked (G, ...) update with grad_clip_norm equals each lane's own
    update bit for bit, as jax.vmap(opt.update) does: lane 0's gradient is
    clipped, lane 1's is under the norm, lane 2 sits at a later step of the
    schedule.  One norm over the cohort would clip lane 1 too."""
    tlr = LR if lr == "float" else SCHEDULES[lr](schedules)
    opt = AdamW(tlr, weight_decay=0.01, grad_clip_norm=2.0)
    params = [to_torch(_grad_seq(s)[0], "cpu") for s in range(3)]
    grads = [tree_map(lambda a, k=k: a * k, to_torch(_grad_seq(9 + i)[0], "cpu"))
             for i, k in enumerate((5.0, 0.05, 1.0))]
    norms = [float(torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(t))))
             for t in grads]
    assert norms[0] > 2.0 > norms[1] and sum(n * n for n in norms) ** 0.5 > 2.0
    states = [opt.init(p) for p in params]
    for _ in range(3):
        states[2] = opt.update(grads[2], states[2], params[2])[1]
    new_p, new_s = opt.update(lora_lib.stack_trees(grads), lora_lib.stack_trees(states),
                              lora_lib.stack_trees(params))
    assert new_s.step.tolist() == [1, 1, 4]
    for i in range(3):
        want_p, want_s = opt.update(grads[i], states[i], params[i])
        got_p, got_s = lora_lib.unstack_tree(new_p)[i], lora_lib.unstack_tree(new_s)[i]
        for got, want in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
            assert torch.equal(got, want)
    # the reference's vmap of its update, on the same lanes
    jopt = JAdamW(LR if lr == "float" else SCHEDULES[lr](j_schedules), weight_decay=0.01,
                  grad_clip_norm=2.0)
    jnew, _ = jax.vmap(jopt.update)(
        jax.tree.map(lambda *xs: jnp.stack(xs), *[_jtree(tree_map(np.asarray, g))
                                                   for g in grads]),
        jax.tree.map(lambda *xs: jnp.stack(xs), *[
            type(s)(*_jtree(tree_map(np.asarray, tuple(s)))) for s in states]),
        jax.tree.map(lambda *xs: jnp.stack(xs), *[_jtree(tree_map(np.asarray, p))
                                                   for p in params]))
    _close_trees(new_p, jnew, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- lora helpers

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


def _cfgs(arch, impl="einsum"):
    jc = j_reduced(J_REGISTRY[arch], n_layers=N_LAYERS[arch])
    tc = reduced(REGISTRY[arch], n_layers=N_LAYERS[arch])
    return (jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)),
            tc.with_(lora=dataclasses.replace(tc.lora, impl=impl)))


def _batch(cfg, rs, lead=(BATCH,)):
    return {"tokens": rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32),
            "targets": rs.integers(0, cfg.vocab_size, lead + (SEQ,)).astype(np.int32)}


def test_lora_helpers_match_reference(state):
    arch, params, lora, _ = state
    tl, tp = to_torch(lora, "cpu"), to_torch(params, "cpu")
    jl = _jtree(lora)
    got, want = lora_lib.adapter_list(tl), j_lora.adapter_list(jl)
    assert [p for p, _, _ in got] == [p for p, _, _ in want] and got
    for (_, ta, tb), (_, ja, jb) in zip(got, want):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert lora_lib.count_adapters(tl) == j_lora.count_adapters(jl)
    one = tree_map(lambda a: a[0], tl)          # one layer's unstacked adapters
    assert lora_lib.count_adapters(one) == j_lora.count_adapters(_jtree(
        tree_map(lambda a: a.numpy(), one)))
    assert lora_lib.adapter_bytes(tl) == j_lora.adapter_bytes(jl)
    bf = tree_map(lambda a: a.to(torch.bfloat16), tl)
    assert lora_lib.adapter_bytes(bf) == lora_lib.adapter_bytes(tl) // 2
    zeros = lora_lib.zeros_like_lora(tl)
    assert all(float(z.abs().max()) == 0.0 and z.shape == a.shape
               for z, a in zip(tree_leaves(zeros), tree_leaves(tl)))
    scale = 2.5
    merged = lora_lib.merge_lora(tp, tl, scale)
    jmerged = j_lora.merge_lora(_jtree(params), jl, scale)
    _close_trees(merged, jmerged, rtol=1e-6, atol=1e-6)
    # the merged model without adapters equals the adapted one
    _, tc = _cfgs(arch)
    tm = build_model(tc.with_(lora=dataclasses.replace(tc.lora, alpha=scale * tc.lora.rank)),
                     device="cpu")
    tb = to_torch(_batch(tc, np.random.default_rng(7)), "cpu")
    with torch.no_grad():
        h_lora, _ = tm.forward_hidden(tp, tl, tb)
        h_merged, _ = tm.forward_hidden(merged, None, tb)
    _close(h_merged, h_lora.numpy(), rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("path", ["sliced", "scan"])
def test_lm_split_steps_match_reference(state, path):
    """client_forward_with_vjp, the LM server step and the client's
    pullback at cut 1, the server step on the sliced path (static cut) and
    on the scan path (the cut a 0-d tensor argument of each call)."""
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt, topt = JAdamW(LR), AdamW(LR)
    cut = 1
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    jpc, jlc, jls = _split(jp, jl, cut, True)
    tpc, tlc, tls = _split(tp, tl, cut, False)
    jv, jvjp = j_splitfl.client_forward_with_vjp(jm, jpc, jlc, jb, cut, path="sliced")
    tv, tvjp = splitfl.client_forward_with_vjp(tm, tpc, tlc, tb, cut)
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
    # the pullback, twice (the reference's vjp may be called again)
    jgc = jvjp(jdv)
    for _ in range(2):
        _close_trees(tvjp(tdv), jgc)


def test_lm_sliced_and_scan_server_steps_agree(state):
    """The two paths of the port's LM server step on the same inputs: loss,
    dv and the new adapters, at every cut."""
    arch, params, lora, batch = state
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    opt = AdamW(LR)
    tp, tl, tb = (to_torch(x, "cpu") for x in (params, lora, batch))
    v = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, tc.d_model)) * 0.5).astype(np.float32))
    scan = splitfl.make_server_step(tm, opt, path="scan")
    for cut in range(N_LAYERS[arch] + 1):
        _, _, ls = _split(tp, tl, cut, False)
        a = splitfl.make_server_step(tm, opt, static_cut=cut)(tp, ls, opt.init(ls), v, tb)
        b = scan(tp, ls, opt.init(ls), v, tb, cut)
        assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
        for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("path", ["scan", "sliced"])
def test_full_train_step_matches_reference(state, remat, path):
    arch, params, lora, batch = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jopt = JAdamW(LR, weight_decay=0.01, grad_clip_norm=1.0)
    topt = AdamW(LR, weight_decay=0.01, grad_clip_norm=1.0)
    jstep = j_splitfl.make_full_train_step(jm, jopt, remat=remat, path=path, donate=False)
    tstep = splitfl.make_full_train_step(tm, topt, remat=remat, path=path)
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
    assert int(ts.step) == 2


def test_full_step_remat_on_and_off_equal(state):
    arch, params, lora, batch = state
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    opt = AdamW(LR)
    outs = []
    for remat in (False, True):
        tl = to_torch(lora, "cpu")
        out = splitfl.make_full_train_step(tm, opt, remat=remat)(
            to_torch(params, "cpu"), tl, opt.init(tl), to_torch(batch, "cpu"))
        outs.append(tree_leaves(out))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------- LM cohort steps

COHORT_B = 2


def _cohort_cuts(arch):
    return (1, N_LAYERS[arch], 2, 1)


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


@pytest.mark.parametrize("impl,chunk", [("vmap", 1), ("vmap", 2), ("vmap", None),
                                        ("ragged", None), ("ragged", 1)])
def test_lm_cohort_step_matches_reference(state, impl, chunk):
    """Per-lane losses, dv and gradients (from the first moment) to 1e-5 of
    their scale, adapters after AdamW to 2*lr, at cuts (1, L, 2, 1)."""
    arch, params, lora, _ = state
    jc, tc = _cfgs(arch)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    cuts = _cohort_cuts(arch)
    lora_s, v, batch = _np_cohort(params, lora, cuts)
    jopt, topt = JAdamW(LR), AdamW(LR)
    jl = _jtree(lora_s)
    jos = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jopt.init(jax.tree.map(lambda a, i=i: a[i], jl)) for i in range(len(cuts))])
    jstep = j_splitfl.make_server_step_batched(jm, jopt, cohort_chunk=chunk, impl=impl,
                                               donate=False)
    jcuts = np.asarray(cuts) if impl == "ragged" else jnp.asarray(cuts)
    jloss, jnl, jno, jdv = jstep(_jtree(params), jl, jos, jnp.asarray(v), _jtree(batch),
                                 jcuts)
    tl = to_torch(lora_s, "cpu")
    tos = lora_lib.stack_trees([topt.init(lo) for lo in lora_lib.unstack_tree(tl)])
    tstep = splitfl.make_server_step_batched(tm, topt, cohort_chunk=chunk, impl=impl)
    tloss, tnl, tno, tdv = tstep(to_torch(params, "cpu"), tl, tos, to_torch(v, "cpu"),
                                 to_torch(batch, "cpu"), list(cuts))
    assert tloss.shape == (len(cuts),)
    assert _norm_err(tloss, jloss) <= 1e-5
    assert _norm_err(tdv, jdv) <= 1e-5
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_norm_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    _close_trees(tnl, jnl, atol=2 * LR, rtol=0)


def test_lm_cohort_lanes_equal_the_sequential_steps(state):
    """Each lane of the vmap and the ragged LM step equals that client's own
    LM server step (losses and dv at 1e-6, first moments at 1e-7)."""
    arch, params, lora, _ = state
    _, tc = _cfgs(arch)
    tm = build_model(tc, device="cpu")
    cuts = _cohort_cuts(arch)
    lora_s, v, batch = _np_cohort(params, lora, cuts, seed=5)
    opt = AdamW(LR)
    tp, tl, tv, tb = (to_torch(x, "cpu") for x in (params, lora_s, v, batch))
    states = [opt.init(lo) for lo in lora_lib.unstack_tree(tl)]
    outs = [splitfl.make_server_step_batched(tm, opt, impl=impl)(
        tp, tl, lora_lib.stack_trees(states), tv, tb, list(cuts))
        for impl in ("vmap", "ragged")]
    for i, cut in enumerate(cuts):
        lane = lambda t, i=i: tree_map(lambda a: a[i], t)  # noqa: E731
        sl, snl, sno, sdv = splitfl.make_server_step(tm, opt, static_cut=cut)(
            tp, lane(tl), states[i], tv[i], lane(tb))
        for loss, nl, no, dv in outs:
            _close(loss[i], sl, atol=1e-6, rtol=0)
            _close(dv[i], sdv, atol=1e-6, rtol=0)
            _close_trees(lane(no.mu), sno.mu, atol=1e-7, rtol=0)
            _close_trees(lane(nl), snl, atol=2 * LR, rtol=0)


def test_batched_impl_names():
    tm = build_model(_cfgs(ARCHS[0])[1], device="cpu")
    for make in (splitfl.make_server_step_batched, splitfl.make_server_step_cls_batched):
        with pytest.raises(KeyError, match="vmap' or 'ragged"):
            make(tm, AdamW(LR), impl="padded")


# ---------------------------------------------------------------- launch/train.py

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_launch_central_mode_runs_on_cpu(tmp_path):
    ckpt = tmp_path / "adapters"
    out = _launch("--mode", "central", "--arch", "gemma-2b", "--reduced", "--steps", "3",
                  "--log-every", "1", "--device", "cpu", "--ckpt", str(ckpt))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    steps = [re.fullmatch(r"step +(\d+) loss=(\d+\.\d{4}) \((\d+\.\d{3})s/step\)", ln)
             for ln in lines[:3]]
    assert all(steps) and [int(m.group(1)) for m in steps] == [1, 2, 3]
    assert lines[3] == f"saved adapters to {ckpt}"
    final = re.fullmatch(r"final loss (\d+\.\d{4}) \(first-10 (\d+\.\d{4})\)", lines[4])
    assert final and np.isfinite(float(final.group(1)))
    from repro_torch.checkpointing import load
    saved = load(str(ckpt), device="cpu")
    assert set(saved) == {"lora", "opt"} and int(saved["opt"][0]) == 3


@pytest.mark.parametrize("schedule", ["constant", "warmup-cosine", "inverse-sqrt"])
def test_launch_optimizer_flags_build_the_reference_optimizer(schedule, monkeypatch):
    """``--schedule``, ``--warmup``, ``--weight-decay`` and ``--grad-clip``
    give the AdamW the reference builds from the same numbers, the learning
    rate step by step; the default flags give the reference's
    ``AdamW(lr)``."""
    from repro_torch.launch import train
    parsed = []
    monkeypatch.setattr(train, "run_central", parsed.append)
    train.main(["--device", "cpu", "--lr", "2e-3", "--steps", "20", "--schedule", schedule,
                "--warmup", "4", "--weight-decay", "0.01", "--grad-clip", "1.0"])
    train.main(["--device", "cpu"])
    opt, default = (train.make_optimizer(args) for args in parsed)
    assert default == AdamW(1e-3)
    assert (opt.weight_decay, opt.grad_clip_norm) == (0.01, 1.0)
    want = {"constant": j_schedules.constant(2e-3),
            "warmup-cosine": j_schedules.linear_warmup_cosine(2e-3, 4, 20),
            "inverse-sqrt": j_schedules.inverse_sqrt(2e-3, 4)}[schedule]
    for step in range(25):
        lr = opt.learning_rate
        got = lr(torch.tensor(step, dtype=torch.int32)) if callable(lr) else np.float32(lr)
        assert np.float32(got) == np.float32(want(jnp.int32(step)))


def test_launch_central_mode_with_optimizer_flags_runs_on_cpu():
    out = _launch("--mode", "central", "--arch", "gemma-2b", "--reduced", "--steps", "3",
                  "--log-every", "1", "--device", "cpu", "--schedule", "warmup-cosine",
                  "--warmup", "1", "--weight-decay", "0.01", "--grad-clip", "1.0")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert all(re.fullmatch(r"step +\d+ loss=\d+\.\d{4} \(\d+\.\d{3}s/step\)", ln)
               for ln in lines[:3])
    final = re.fullmatch(r"final loss (\d+\.\d{4}) \(first-10 (\d+\.\d{4})\)", lines[3])
    assert final and np.isfinite(float(final.group(1)))


def test_launch_sfl_mode_runs_on_cpu():
    out = _launch("--mode", "sfl", "--reduced", "--steps", "2", "--log-every", "1",
                  "--n-train", "400", "--batch", "4", "--seq", "32", "--agg-interval", "2",
                  "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    rounds = [re.fullmatch(r"\[ours/ours\] round +(\d+) t= *\d+\.\ds loss=\d+\.\d{4} "
                           r"acc=\d\.\d{4} f1=\d\.\d{4}", ln) for ln in lines[:2]]
    assert all(rounds)
    assert re.fullmatch(r"\[ours\] simulated time \d+\.\ds  server memory \d+\.\d MB",
                        lines[2])


def test_launch_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _launch("--mode", "central", "--reduced", "--steps", "1")
    assert out.returncode != 0 and "no CUDA device" in out.stderr
