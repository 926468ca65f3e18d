"""The reference's plain ``chunked`` forms in the port: ``_attention_chunked``
(online softmax over key chunks) and ``wkv_chunked`` (the log-space
chunk-parallel WKV), against the JAX package's in fp32 — outputs and
gradients, at shifted positions, windows, GQA, ragged lengths and a given
WKV state — and the up-front choice between them and the kernels: the
kernel only inside its domain (no gradient, arange positions, zero state),
the plain form otherwise, and whole decoder LMs differentiated under
``attn_impl`` / ``wkv_impl="chunked"``.

Tolerance: 1e-5 of each output's (or gradient's) largest magnitude — fp32
sums taken in another order by XLA and by PyTorch's CPU kernels.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

set_fp32_policy()

TOL = 1e-5


def _err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _t(x):
    return torch.from_numpy(np.array(x)).requires_grad_(np.issubdtype(x.dtype, np.floating))


# --------------------------------------------------------------- attention

ATTN_CASES = {
    # b, s, t, h, kh, d, causal, window, q offset, k offset, chunk
    "causal": (2, 12, 12, 4, 4, 16, True, None, 0, 0, 4),
    "gqa_ragged_chunk": (1, 11, 11, 4, 2, 8, True, None, 0, 0, 4),
    "window": (2, 13, 13, 4, 1, 16, True, 5, 0, 0, 8),
    "shifted_positions": (1, 6, 10, 2, 1, 16, True, None, 4, 0, 4),
    "non_causal_offset": (2, 7, 9, 4, 2, 8, False, None, 30, 25, 4),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_chunked_matches_reference(case):
    b, s, t, h, kh, d, causal, window, qo, ko, chunk = ATTN_CASES[case]
    rs = np.random.default_rng(0)
    q = rs.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rs.standard_normal((b, t, kh, d)).astype(np.float32) for _ in range(2))
    g = rs.standard_normal((b, s, h * d)).astype(np.float32)
    q_pos = (np.arange(s) + qo).astype(np.int32)
    k_pos = (np.arange(t) + ko).astype(np.int32)

    def j_fn(q_, k_, v_):
        return JL._attention_chunked(q_, k_, v_, causal=causal, window=window,
                                     q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                     chunk=chunk)

    want, vjp = jax.vjp(j_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = L._attention_chunked(tq, tk, tv, causal=causal, window=window,
                               q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
                               chunk=chunk)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _err(got, want) <= TOL
    for name, gg, wg in zip("qkv", got_grads, want_grads):
        assert _err(gg, wg) <= TOL, name


def test_attention_full_chunked_equals_naive_at_any_positions():
    """The plain chunked form computes what the naive form computes, at
    shifted positions too (where the kernel would not run)."""
    rs = np.random.default_rng(1)
    q = torch.from_numpy(rs.standard_normal((2, 9, 4, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rs.standard_normal((2, 9, 2, 8)).astype(np.float32))
            for _ in range(2))
    pos = torch.arange(9) + 3
    kw = dict(causal=True, window=4, q_pos=pos, k_pos=pos)
    naive = L.attention_full(q, k, v, impl="naive", **kw)
    chunked = L.attention_full(q, k, v, impl="chunked", chunk=4, **kw)
    assert _err(chunked, naive.numpy()) <= TOL


# --------------------------------------------------------------------- WKV

WKV_CASES = {
    # b, s, h, d, chunk, state, decay z mean
    "zero_state": (2, 16, 2, 8, 4, False, -3.0),
    "given_state": (2, 12, 3, 8, 4, True, -3.0),
    "ragged_length": (1, 11, 2, 16, 4, True, -2.0),
    "default_chunk": (2, 37, 2, 8, 16, True, -3.0),
}


def _wkv_inputs(b, s, h, d, with_state, zmean, seed=2):
    rs = np.random.default_rng(seed)
    r, k, v = ((rs.standard_normal((b, s, h, d)) * 0.3).astype(np.float32) for _ in range(3))
    decay = np.exp(-np.exp(rs.standard_normal((b, s, h, d)) + zmean)).astype(np.float32)
    u = (rs.standard_normal((h, d)) * 0.5).astype(np.float32)
    state = ((rs.standard_normal((b, h, d, d)) * 0.5).astype(np.float32) if with_state
             else np.zeros((b, h, d, d), np.float32))
    return r, k, v, decay, u, state


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_chunked_matches_reference(case):
    b, s, h, d, chunk, with_state, zmean = WKV_CASES[case]
    inputs = _wkv_inputs(b, s, h, d, with_state, zmean)
    rs = np.random.default_rng(3)
    g_out = rs.standard_normal((b, s, h, d)).astype(np.float32)
    g_state = rs.standard_normal((b, h, d, d)).astype(np.float32)

    def j_fn(*args):
        return JB.wkv_chunked(*args, chunk=chunk)

    (want, want_state), vjp = jax.vjp(j_fn, *map(jnp.asarray, inputs))
    want_grads = vjp((jnp.asarray(g_out), jnp.asarray(g_state)))
    tin = [_t(x) for x in inputs]
    got, got_state = B.wkv_chunked(*tin, chunk=chunk)
    got_grads = torch.autograd.grad((got, got_state), tin,
                                    (torch.from_numpy(g_out), torch.from_numpy(g_state)))
    assert _err(got, want) <= TOL
    assert _err(got_state, want_state) <= TOL
    for name, gg, wg in zip(("r", "k", "v", "decay", "u", "state"), got_grads, want_grads):
        assert _err(gg, wg) <= TOL, name


def test_wkv_chunked_equals_scan_from_a_state():
    """From a given state the plain chunked form computes the step-by-step
    recurrence."""
    inputs = [torch.from_numpy(x) for x in _wkv_inputs(2, 13, 2, 8, True, -2.0, seed=4)]
    out, state = B.wkv_chunked(*inputs, chunk=4)
    out_s, state_s = B.wkv_scan(*inputs)
    assert _err(out, out_s.numpy()) <= TOL and _err(state, state_s.numpy()) <= TOL


# ------------------------------------------------------------ the choice

class _Calls:
    """Counts calls of a wrapper and forwards them."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def test_attention_choice_takes_plain_under_grad(monkeypatch):
    calls = _Calls(ops.flash_attention_apply)
    monkeypatch.setattr(ops, "flash_attention_apply", calls)
    rs = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rs.standard_normal((1, 8, 2, 8)).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(8)
    kw = dict(causal=True, window=None, impl="chunked", chunk=4)
    with torch.no_grad():
        L.attention_full(q, k, v, q_pos=pos, k_pos=pos, **kw)
    assert calls.n == 1                                 # the kernel's domain
    L.attention_full(q, k, v, q_pos=pos + 2, k_pos=pos + 2, **kw)
    assert calls.n == 1                                 # shifted: plain
    y = L.attention_full(q.requires_grad_(True), k, v, q_pos=pos, k_pos=pos, **kw)
    assert calls.n == 1 and y.requires_grad             # under grad: plain
    L.attention_full(q.detach(), k, v, q_pos=pos, k_pos=pos, arange=True, **kw)
    assert calls.n == 2                                 # no input asks: kernel


def test_wkv_choice_takes_plain_for_a_state_or_under_grad(monkeypatch):
    calls = _Calls(ops.wkv6_apply)
    monkeypatch.setattr(ops, "wkv6_apply", calls)
    cfg = reduced(REGISTRY["rwkv6-3b"]).with_(wkv_impl="chunked", wkv_chunk=4)
    r, k, v, decay, u, state = (torch.from_numpy(x)
                                for x in _wkv_inputs(1, 8, 2, 8, True, -3.0))
    B.wkv_apply(cfg, r, k, v, decay, u)
    assert calls.n == 1                                 # zero state, no grad: kernel
    out, final = B.wkv_apply(cfg, r, k, v, decay, u, state)
    assert calls.n == 1                                 # a given state: plain
    want, want_state = B.wkv_scan(r, k, v, decay, u, state)
    assert _err(out, want.numpy()) <= TOL and _err(final, want_state.numpy()) <= TOL
    out = B.wkv_apply(cfg, r.requires_grad_(True), k, v, decay, u)[0]
    assert calls.n == 1 and out.requires_grad           # under grad: plain


# ------------------------------------------------- whole models under grad

@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-3b"])
def test_lm_adapter_gradients_under_chunked_match_reference(arch):
    """The token cross-entropy's gradient with respect to every adapter
    leaf, through a 2-layer reduced LM under attn_impl / wkv_impl
    "chunked" with chunks shorter than the sequence, against the
    reference's jax.grad of the same loss."""
    kw = dict(attn_impl="chunked", wkv_impl="chunked", attn_chunk=4, wkv_chunk=4)
    jc = j_reduced(J_REGISTRY[arch]).with_(**kw)
    tc = reduced(REGISTRY[arch]).with_(**kw)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rs = np.random.default_rng(6)
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype),
                        jm.init_lora(jax.random.PRNGKey(1)))
    batch = {"tokens": rs.integers(0, jc.vocab_size, (2, 10)).astype(np.int32),
             "targets": rs.integers(0, jc.vocab_size, (2, 10)).astype(np.int32)}

    def j_loss(lo):
        return jm.loss(jax.tree.map(jnp.asarray, params), lo,
                       {k: jnp.asarray(v) for k, v in batch.items()})[0]

    j_val, j_grads = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray, lora))
    t_lora = tree_map(lambda x: x.requires_grad_(True), to_torch(lora, "cpu"))
    t_val = tm.loss(to_torch(params, "cpu"), t_lora, to_torch(batch, "cpu"))[0]
    t_grads = torch.autograd.grad(t_val, tree_leaves(t_lora))
    assert _err(t_val, j_val) <= TOL
    want = jax.tree.leaves(j_grads)
    assert len(t_grads) == len(want)
    for got, w in zip(t_grads, want):
        assert _err(got, w) <= TOL
