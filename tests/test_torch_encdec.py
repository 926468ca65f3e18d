"""The port's encoder-decoder (whisper) against the JAX package, from
bridged weights, on reduced whisper-large-v3 (3 encoder and 3 decoder
layers, ``encoder_seq`` 16) in fp32: ``encode`` (full, and the client's
activations before ``enc_norm``, on the whole stack and on a truncated
one), ``loss`` (full, and the server's from the cut activations),
``prefill``, ``serve_step`` from a cache whose cross-attention K/V come
from the prefill, the adapter gradients against ``jax.grad``, the split
steps (client forward, LM server step) and the full train step; then
``input_specs`` and ``cache_spec`` against the reference's for every
registered config and input shape, and ``build_model`` on every device.

Tolerances: values normalised by their own scale within 2e-5 (fp32 sums
in another order, as tests/test_torch_families.py); decode against the
teacher-forced forward at the reference's atol 2e-3
(tests/test_models_smoke.py); gradients at 1e-4 in the relative 2-norm;
adapters after AdamW at 2*lr per element and step (ROADMAP Queue C).
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

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
from repro.configs.shapes import ASSIGNED_SHAPES as J_ASSIGNED  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.core import splitfl as j_splitfl  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.api import input_specs as j_input_specs  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.configs.shapes import ASSIGNED_SHAPES, SHAPES  # noqa: E402
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.core import splitfl  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import input_specs  # noqa: E402
from repro_torch.models.encdec import EncDecModel  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

set_fp32_policy()

TOL = 2e-5
DECODE_ATOL = 2e-3
GRAD_TOL = 1e-4
LR = 1e-3
ARCH = "whisper-large-v3"
N_LAYERS = 3
BATCH, SEQ = 2, 9


def _cfgs():
    return (j_reduced(J_REGISTRY[ARCH], n_layers=N_LAYERS),
            reduced(REGISTRY[ARCH], n_layers=N_LAYERS))


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


def _max_abs(got, want) -> float:
    if isinstance(got, dict):
        return max(_max_abs(got[k], want[k]) for k in got)
    return float(np.abs(_np(got) - _np(want)).max())


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return to_torch(tree, "cpu")


def _batch(cfg, rs):
    return {"frames": rs.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32),
            "tokens": rs.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "targets": rs.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}


@pytest.fixture(scope="module")
def state():
    jc, tc = _cfgs()
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return jm, build_model(tc, device="cpu"), params, lora, _batch(jc, rs)


def test_init_trees_match_reference():
    jc, tc = _cfgs()
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    assert isinstance(tm, EncDecModel)
    gen = torch.Generator().manual_seed(0)
    for j_tree, t_tree in ((jm.init_params(jax.random.PRNGKey(0)), tm.init_params(gen)),
                           (jm.init_lora(jax.random.PRNGKey(1)), tm.init_lora(gen)),
                           (jm.params_spec(), tm.params_spec())):
        j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
        t_flat = dict(jax.tree_util.tree_flatten_with_path(t_tree)[0])
        assert len(j_flat) == len(t_flat)
        for path, want in j_flat:
            assert tuple(t_flat[path].shape) == want.shape, path
            assert str(t_flat[path].dtype) == f"torch.{want.dtype}", path


@pytest.mark.parametrize("side,cut", [("full", 0), ("client", 2), ("server", 1)])
def test_encode_matches_reference(state, side, cut):
    """The client's activations come back before ``enc_norm``."""
    jm, tm, params, lora, batch = state
    want = jm.encode(_jtree(params), _jtree(lora), jnp.asarray(batch["frames"]),
                     cut=cut, side=side)
    got = tm.encode(_t(params), _t(lora), torch.from_numpy(batch["frames"]), cut=cut,
                    side=side)
    assert _err(got, want) <= TOL
    tensor_cut = tm.encode(_t(params), _t(lora), torch.from_numpy(batch["frames"]),
                           cut=torch.tensor(cut), side=side)
    assert _err(tensor_cut, want) <= TOL


def test_client_encode_on_a_truncated_stack(state):
    """The client holds only its layers and adapters: the same activations
    as the whole stack masked at the cut, bit for bit."""
    _, tm, params, lora, batch = state
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    cut = 2
    pc = dict(tp, enc_layers=lora_lib.slice_stack(tp["enc_layers"], 0, cut))
    lc, ls = lora_lib.split_lora(tl, cut)
    assert set(lc) == {"enc_layers"} and ls["dec_layers"] is tl["dec_layers"]
    v, aux = tm.forward_hidden(pc, lc, tb, cut=cut, side="client")
    assert float(aux) == 0.0
    assert torch.equal(v, tm.forward_hidden(tp, tl, tb, cut=cut, side="client")[0])


@pytest.mark.parametrize("cut", [0, 2, N_LAYERS])
def test_loss_matches_reference(state, cut):
    """Full loss and logits, and the server's from the cut activations."""
    jm, tm, params, lora, batch = state
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    jloss, jlog = jm.loss(jp, jl, jb)
    tloss, tlog = tm.loss(tp, tl, tb)
    assert _err(tloss, jloss) <= TOL and _err(tlog, jlog) <= TOL
    jv = jm.forward_hidden(jp, jl, jb, cut=cut, side="client")[0]
    tv = tm.forward_hidden(tp, tl, tb, cut=cut, side="client")[0]
    jloss, jlog = jm.loss(jp, jl, jb, cut=cut, side="server", x0=jv)
    tloss, tlog = tm.loss(tp, tl, tb, cut=cut, side="server", x0=tv)
    assert _err(tloss, jloss) <= TOL and _err(tlog, jlog) <= TOL
    with pytest.raises(ValueError, match="forward_hidden"):
        tm.loss(tp, tl, tb, side="client")


def test_prefill_matches_reference(state):
    jm, tm, params, lora, batch = state
    pre = {k: batch[k] for k in ("frames", "tokens")}
    jlog, jcache = jm.prefill(_jtree(params), _jtree(lora), _jtree(pre))
    tlog, tcache = tm.prefill(_t(params), _t(lora), _t(pre))
    assert tcache["k"].shape == (N_LAYERS, BATCH, SEQ, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    assert _err(tlog, jlog) <= TOL and _tree_err(tcache, jcache) <= TOL


def test_serve_step_from_a_cross_filled_cache(state):
    """The prefill's cache holds the prompt's length and cannot be decoded
    into: a fresh ``init_cache`` takes its cross-attention K/V, and the
    prompt is fed token by token (the cache written in place).  Each
    step's logits against the reference's step on the same cache (TOL) and
    against the teacher-forced logits (the reference's atol)."""
    jm, tm, params, lora, batch = state
    jp, jl = _jtree(params), _jtree(lora)
    tp, tl = _t(params), _t(lora)
    pre = {k: batch[k] for k in ("frames", "tokens")}
    _, tfull = tm.loss(tp, tl, _t(batch))
    _, tpre = tm.prefill(tp, tl, _t(pre))
    _, jpre = jm.prefill(jp, jl, _jtree(pre))
    cache = tm.init_cache(BATCH, SEQ + 3)
    for key in ("xk", "xv"):
        cache[key].copy_(tpre[key])
    jcache = jm.init_cache(BATCH, SEQ + 3)
    jcache = dict(jcache, xk=jpre["xk"], xv=jpre["xv"])
    toks = batch["tokens"]
    outs = []
    for i in range(SEQ):
        lg, same = tm.serve_step(tp, tl, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert same is cache
        jlg, jcache = jm.serve_step(jp, jl, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i))
        assert _err(lg, jlg) <= TOL
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(tfull), atol=DECODE_ATOL)
    assert _tree_err(cache, jcache) <= TOL


def test_adapter_grads_match_jax_grad(state):
    """Encoder and decoder adapters (self- and cross-attention)."""
    jm, tm, params, lora, batch = state

    def jloss(lo):
        return jm.loss(_jtree(params), lo, _jtree(batch))[0]

    jg = jax.tree_util.tree_flatten_with_path(jax.grad(jloss)(_jtree(lora)))[0]
    tl = tree_map(lambda a: a.requires_grad_(True), _t(lora))
    tloss, _ = tm.loss(_t(params), tl, _t(batch))
    flat = jax.tree_util.tree_flatten_with_path(tl)[0]
    got = dict(zip([p for p, _ in flat], torch.autograd.grad(tloss, [t for _, t in flat])))
    assert len(got) == len(jg)
    assert any("xattn" in jax.tree_util.keystr(p) for p, _ in jg)
    for path, want in jg:
        g, w = _np(got[path]), _np(want)
        assert np.linalg.norm(g - w) <= GRAD_TOL * max(np.linalg.norm(w), 1e-30), \
            jax.tree_util.keystr(path)


def test_split_steps_match_reference(state):
    """Client forward at cut 2 on the client's own part, the LM server step
    from its activations (the encoder's server layers, the decoder's
    adapters server-only), and the client's backward from dv."""
    jm, tm, params, lora, batch = state
    cut = 2
    jopt, topt = JAdamW(LR), AdamW(LR)
    jp, jl, jb = _jtree(params), _jtree(lora), _jtree(batch)
    tp, tl, tb = _t(params), _t(lora), _t(batch)
    jlc, jls = j_lora.split_lora(jl, cut)
    jspec = jax.eval_shape(lambda: jl)
    jls = j_lora.embed_in_full_shape(jls, jspec, cut, "server")
    # the reference's masked scan takes the whole stack: the client's part in zeros
    jv = j_splitfl.client_forward(jm, jp, j_lora.embed_in_full_shape(jlc, jspec, cut,
                                                                     "client"), jb, cut)
    tpc = dict(tp, enc_layers=lora_lib.slice_stack(tp["enc_layers"], 0, cut))
    tlc, tls = lora_lib.split_lora(tl, cut)
    tls = lora_lib.embed_in_full_shape(tls, tl, cut, "server")
    fwd, bwd = splitfl.make_client_step(tm, topt, cut)
    tv, tape = fwd(tpc, tlc, tb)
    assert _err(tv, jv) <= TOL
    jstep = j_splitfl.make_server_step(jm, jopt, static_cut=cut, donate=False)
    tstep = splitfl.make_server_step(tm, topt, static_cut=cut)
    jloss, jnl, jno, jdv = jstep(jp, jls, jopt.init(jls), jv, jb)
    tloss, tnl, tno, tdv = tstep(tp, tls, topt.init(tls), tv, tb)
    assert _err(tloss, jloss) <= TOL and _err(tdv, jdv) <= TOL
    grad = lambda mu: tree_map(lambda m: np.asarray(m) / (1 - 0.9), mu)  # noqa: E731
    assert _tree_err(grad(tree_map(np.asarray, tno.mu)), grad(jno.mu)) <= 1e-5
    assert _max_abs(tnl, jnl) <= 2 * LR
    # the client's adapters from dv, against jax.vjp of the reference's forward
    _, vjp = jax.vjp(lambda lo: jm.forward_hidden(jp, j_lora.embed_in_full_shape(
        lo, jspec, cut, "client"), jb, cut=cut, side="client")[0], jlc)
    (jgc,) = vjp(jdv)
    new_lc, new_co = bwd(tape, topt.init(tlc), tdv)
    assert _tree_err(grad(tree_map(np.asarray, new_co.mu)), jgc) <= 1e-5
    assert set(new_lc) == {"enc_layers"}


@pytest.mark.parametrize("remat", [False, True])
def test_full_train_step_matches_reference(state, remat):
    jm, tm, params, lora, batch = state
    jopt, topt = JAdamW(LR), AdamW(LR)
    jstep = j_splitfl.make_full_train_step(jm, jopt, remat=remat, donate=False)
    tstep = splitfl.make_full_train_step(tm, topt, remat=remat)
    jl, tl = _jtree(lora), _t(lora)
    jloss, jl, _ = jstep(_jtree(params), jl, jopt.init(jl), _jtree(batch))
    tloss, tl2, _ = tstep(_t(params), tl, topt.init(tl), _t(batch))
    assert _err(tloss, jloss) <= TOL and _max_abs(tl2, jl) <= 2 * LR
    other = splitfl.make_full_train_step(tm, topt, remat=not remat)(
        _t(params), tl, topt.init(tl), _t(batch))
    assert torch.equal(other[0], tloss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(other[1]), tree_leaves(tl2)))


# ---------------------------------------------------------------- input specs

def _spec_pairs():
    return [(arch, shape) for arch in sorted(J_REGISTRY)
            for shape in ("paper_ft",) + tuple(J_ASSIGNED)]


@pytest.mark.parametrize("arch,shape", _spec_pairs())
def test_input_specs_match_reference(arch, shape):
    """Every registered config at the paper's shape and every assigned
    shape: the same inputs with the same shapes and dtype names (the port's
    are ``meta`` tensors: nothing is allocated), the decode caches
    included (``cache_spec``); where the reference's text length is
    negative (internvl2-26b's 1024 vision tokens in paper_ft's 128), the
    port raises."""
    assert tuple(ASSIGNED_SHAPES) == tuple(J_ASSIGNED)
    j_specs = j_input_specs(J_REGISTRY[arch], J_SHAPES[shape])
    if any(d < 0 for leaf in jax.tree.leaves(j_specs) for d in leaf.shape):
        # a VLM shape shorter than its vision prefix: the reference gives a
        # negative text length, the port refuses the shape
        with pytest.raises(ValueError, match="vision tokens"):
            input_specs(REGISTRY[arch], SHAPES[shape])
        return
    t_specs = input_specs(REGISTRY[arch], SHAPES[shape])
    j_flat = jax.tree_util.tree_flatten_with_path(j_specs)[0]
    t_flat = dict(jax.tree_util.tree_flatten_with_path(t_specs)[0])
    assert len(j_flat) == len(t_flat)
    for path, want in j_flat:
        got = t_flat[path]
        assert got.device.type == "meta", path
        assert tuple(got.shape) == tuple(want.shape), path
        assert str(got.dtype) == f"torch.{want.dtype}", path


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3", "gemma-2b"])
def test_cache_spec_matches_reference(arch):
    j, t = j_build(J_REGISTRY[arch]), build_model(REGISTRY[arch], device="meta")
    j_flat = jax.tree_util.tree_flatten_with_path(j.cache_spec(3, 40))[0]
    t_flat = dict(jax.tree_util.tree_flatten_with_path(t.cache_spec(3, 40))[0])
    assert len(j_flat) == len(t_flat)
    for path, want in j_flat:
        assert tuple(t_flat[path].shape) == want.shape, path
        assert str(t_flat[path].dtype) == f"torch.{want.dtype}", path


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_new_families_build_on_every_device(arch):
    """The card by default (raising here, where there is none: nothing
    falls back), the CPU and ``meta`` when asked; at full size on meta
    every parameter's shape and dtype is the reference's."""
    cfg = REGISTRY[arch]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    small = build_model(reduced(cfg), device="cpu")
    assert small.device.type == "cpu"
    full = build_model(cfg, device="meta").params_spec()
    t_flat = dict(jax.tree_util.tree_flatten_with_path(full)[0])
    j_flat = jax.tree_util.tree_flatten_with_path(j_build(J_REGISTRY[arch]).params_spec())[0]
    assert len(t_flat) == len(j_flat)
    for path, want in j_flat:
        got = t_flat[path]
        assert got.device.type == "meta" and tuple(got.shape) == want.shape, path
        assert str(got.dtype) == f"torch.{want.dtype}", path
