"""The port's decoder LMs against the JAX package's, from bridged weights:
gemma-2b (dense, MQA, GeGLU, RoPE, RMSNorm) and rwkv6-3b (RWKV6), reduced
to 2 layers of d 256 in fp32.  Teacher-forced loss and logits, the
prefill's last-position logits and its caches (roped K/V; shifts and WKV
state), and decode steps of ``serve_step`` (with and without a window, and
past the end of the cache), each held against the reference.  The port
runs its plain settings (``attn_impl="naive"``, ``wkv_impl="scan"``) and
its kernel settings (``"chunked"``: the flash and WKV6 kernels' wrappers,
whose plain versions run on the CPU), against both reference settings.

Tolerance: rtol 1e-4 / atol 2e-5 — fp32 values before any optimizer step,
products summed in another order by XLA and by PyTorch's CPU BLAS, and the
reference's chunked formulas (per-chunk online softmax, the log-space WKV)
against the port's plain ones.
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
from repro.models import build_model as j_build  # noqa: E402
from repro.models import supports_decode as j_supports_decode  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.models import build_model, supports_decode  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()

RTOL, ATOL = 1e-4, 2e-5
ARCHS = ["gemma-2b", "rwkv6-3b"]
IMPLS = {"plain": {"attn_impl": "naive", "wkv_impl": "scan"},
         "chunked": {"attn_impl": "chunked", "wkv_impl": "chunked"}}
BATCH, SEQ = 2, 12


def _cfgs(arch, impl="plain", **kw):
    return (j_reduced(J_REGISTRY[arch]).with_(**IMPLS[impl], **kw),
            reduced(REGISTRY[arch]).with_(**IMPLS[impl], **kw))


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
    toks = rs.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32)
    tgts = rs.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return arch, params, lora, {"tokens": toks, "targets": tgts}


def _models(arch, j_impl, t_impl, **kw):
    jc, _ = _cfgs(arch, j_impl, **kw)
    _, tc = _cfgs(arch, t_impl, **kw)
    return j_build(jc), build_model(tc, device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _jargs(params, lora):
    return jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora)


@pytest.mark.parametrize("j_impl", list(IMPLS))
@pytest.mark.parametrize("t_impl", list(IMPLS))
def test_loss_and_logits_match(state, j_impl, t_impl):
    arch, params, lora, batch = state
    jm, tm = _models(arch, j_impl, t_impl)
    jl, jlog = jm.loss(*_jargs(params, lora), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tlog = tm.loss(to_torch(params, "cpu"), to_torch(lora, "cpu"),
                           to_torch(batch, "cpu"))
    _close(tlog, jlog)
    _close(tl, jl)


@pytest.mark.parametrize("j_impl", list(IMPLS))
@pytest.mark.parametrize("t_impl", list(IMPLS))
def test_prefill_logits_and_cache_match(state, j_impl, t_impl):
    arch, params, lora, batch = state
    jm, tm = _models(arch, j_impl, t_impl)
    jlog, jcache = jm.prefill(*_jargs(params, lora), {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        tlog, tcache = tm.prefill(to_torch(params, "cpu"), to_torch(lora, "cpu"),
                                  {"tokens": torch.from_numpy(batch["tokens"])})
    assert tuple(tlog.shape) == (BATCH, 1, jm.cfg.vocab_size)
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("j_impl", list(IMPLS))
@pytest.mark.parametrize("t_impl", list(IMPLS))
def test_sliding_window_prefill_matches_reference(j_impl, t_impl):
    """gemma-2b under a sliding window of 5 (the long-context variant):
    the flash kernel's window mask against the reference's."""
    jc, _ = _cfgs("gemma-2b", j_impl, sliding_window=5)
    _, tc = _cfgs("gemma-2b", t_impl, sliding_window=5)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(2)))
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32)
    jlog, jcache = jm.prefill(jax.tree.map(jnp.asarray, params), {},
                              {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, tcache = tm.prefill(to_torch(params, "cpu"), {},
                                  {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog)
    for key in jcache:
        _close(tcache[key], jcache[key])


def _decode(model, params, lora, cache_len, tokens, torch_side, window=None):
    """Feed ``tokens`` (B, n) one at a time from a zero cache; returns the
    per-step logits (B, n, V) and the final cache."""
    n = tokens.shape[1]
    cache = model.init_cache(tokens.shape[0], cache_len)
    outs = []
    for i in range(n):
        if torch_side:
            with torch.no_grad():
                lg, cache = model.serve_step(params, lora, cache,
                                             torch.from_numpy(tokens[:, i:i + 1]), i,
                                             window=window)
            outs.append(lg[:, 0].numpy())
        else:
            lg, cache = model.serve_step(params, lora, cache,
                                         jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i),
                                         window=window)
            outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1), cache


# cache_len 16: 6 steps inside the cache; 4: steps 4 and 5 land past its
# end (the reference's dynamic_update_slice clamps them to the last slot);
# 4 with a window of 4: the slots wrap around (pos % cache_len)
@pytest.mark.parametrize("cache_len,window", [(16, None), (4, None), (4, 4)])
@pytest.mark.parametrize("t_impl", list(IMPLS))
def test_decode_steps_match(state, cache_len, window, t_impl):
    arch, params, lora, batch = state
    jm, tm = _models(arch, "plain", t_impl)
    toks = batch["tokens"][:, :6]
    jlog, jcache = _decode(jm, *_jargs(params, lora), cache_len, toks, False, window)
    tlog, tcache = _decode(tm, to_torch(params, "cpu"), to_torch(lora, "cpu"),
                           cache_len, toks, True, window)
    _close(torch.from_numpy(tlog), jlog)
    for key in jcache:
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("t_impl", list(IMPLS))
def test_decode_matches_own_parallel_forward(state, t_impl):
    """Token-by-token decode logits == the port's own teacher-forced
    forward (the reference's invariant, on the port alone)."""
    arch, params, lora, batch = state
    _, tm = _models(arch, "plain", t_impl)
    tp, tl = to_torch(params, "cpu"), to_torch(lora, "cpu")
    with torch.no_grad():
        _, full = tm.loss(tp, tl, to_torch(batch, "cpu"))
    dec, _ = _decode(tm, tp, tl, SEQ, batch["tokens"], True)
    np.testing.assert_allclose(dec, full.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_every_leaf(arch, dtype):
    """to_torch keeps the reference's key paths, shapes, dtypes and bits,
    nested RWKV tm/cm trees and the f32 leaves of a bf16 model included,
    and the port's own init builds the same tree."""
    jc, tc = (c.with_(dtype=dtype) for c in _cfgs(arch))
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    for j_tree, t_init in ((jm.init_params(jax.random.PRNGKey(0)), tm.init_params),
                           (jm.init_lora(jax.random.PRNGKey(1)), tm.init_lora)):
        np_tree = jax.tree.map(np.asarray, j_tree)
        bridged = to_torch(np_tree, "cpu")
        own = t_init(torch.Generator().manual_seed(0))
        j_flat = jax.tree_util.tree_flatten_with_path(np_tree)[0]
        b_flat = dict(jax.tree_util.tree_flatten_with_path(bridged)[0])
        o_flat = dict(jax.tree_util.tree_flatten_with_path(own)[0])
        assert len(j_flat) == len(b_flat) == len(o_flat)
        for path, want in j_flat:
            got = b_flat[path]
            name = str(want.dtype)
            assert str(got.dtype) == f"torch.{name}", (path, got.dtype, name)
            assert str(o_flat[path].dtype) == f"torch.{name}", path
            assert tuple(got.shape) == want.shape == tuple(o_flat[path].shape), path
            if name == "bfloat16":
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    if arch == "rwkv6-3b":
        assert bridged["layers"]["tm"]["wr"]["a"].dtype == torch.float32
        assert to_torch(jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0))),
                        "cpu")["layers"]["tm"]["u"].dtype == torch.float32


FAMILY_ARCHS = {"moe": "qwen3-moe-30b-a3b", "hybrid": "zamba2-7b", "vlm": "internvl2-26b",
                "encdec": "whisper-large-v3"}


@pytest.mark.parametrize("family", ["moe", "hybrid", "vlm", "encdec"])
def test_families_outside_the_slice_raise(family):
    """The families ported after the first LM slice (moe and vlm in one,
    hybrid and encdec in the next) build from their registered configs,
    reduced, and run a finite forward on the CPU (tests/test_torch_moe.py,
    tests/test_torch_families.py, tests/test_torch_hybrid.py and
    tests/test_torch_encdec.py hold them against the reference); whether
    each decodes is the reference's answer."""
    arch = FAMILY_ARCHS[family]
    tc = reduced(REGISTRY[arch])
    assert supports_decode(tc) == j_supports_decode(j_reduced(J_REGISTRY[arch]))
    model = build_model(tc, device="cpu")
    assert model.cfg.family == family
    params = model.init_params(torch.Generator().manual_seed(0))
    rs = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rs.integers(0, tc.vocab_size, (1, 8)).astype(np.int32))}
    if family == "encdec":
        batch["frames"] = torch.from_numpy(
            rs.standard_normal((1, tc.encoder_seq, tc.d_model)).astype(np.float32))
    if family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rs.standard_normal((1, tc.n_vision_tokens, tc.vision_embed_dim)).astype(np.float32))
    h, _ = model.forward_hidden(params, None, batch, side="full")
    assert h.shape[0] == 1 and h.shape[-1] == tc.d_model
    assert bool(torch.isfinite(h).all())


def test_supports_decode_matches_reference():
    for name in J_REGISTRY:
        assert supports_decode(REGISTRY[name]) == j_supports_decode(J_REGISTRY[name])


def test_unported_knobs_raise():
    """Unknown attention and WKV impls raise.  (The int8 KV cache and qkv
    biases, which raised here before their slice, are held against the
    reference in tests/test_torch_families.py.)"""
    # shifted positions and a given WKV state no longer raise under
    # "chunked": they take the plain chunked forms (tests/test_torch_chunked.py)
    q = torch.zeros(1, 4, 4, 64)
    pos = torch.arange(4)
    with pytest.raises(KeyError):
        L.attention_full(q, q, q, causal=True, window=None, q_pos=pos, k_pos=pos,
                         impl="flash")
    _, rc = _cfgs("rwkv6-3b", "chunked")
    r = torch.zeros(1, 4, 8, 32)
    with pytest.raises(KeyError):
        B.wkv_apply(rc.with_(wkv_impl="pallas"), r, r, r, r, torch.zeros(8, 32))
