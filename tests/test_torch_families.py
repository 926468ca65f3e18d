"""The families and knobs of the port's A10 slice against the JAX package,
from bridged weights, reduced configs in fp32: qkv biases through
``lora_apply`` (one adapter and cohort-grouped ones, einsum and fused),
the int8 KV cache over a sequence of ``serve_step`` calls, the untied LM
head, the one-hot embedding, the VLM's projector, embedding, loss and
prefill, the teacher-forced loss, logits, prefill and decode of every
newly ported config, and ``supports_long_context`` /
``long_context_variant``; then the port's own rules: which families
build, the stacked init without a per-layer list, and the bridge carrying
a bf16 MoE model's experts, f32 router, biases and projector bit for bit.

Biases are zero at init in both packages, so every comparison that reads
them first draws random ones into the reference's parameters.

Tolerances: values normalised by their own scale within 2e-5 (fp32 sums
in another order, as tests/test_torch_lm.py); the int8 cache's codes bit
for bit and its scales within 1e-5.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
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
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import long_context_variant as j_long_context_variant  # noqa: E402
from repro.models import supports_long_context as j_supports_long_context  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.core.lora import stack_trees  # noqa: E402
from repro_torch.models import (build_model, long_context_variant,  # noqa: E402
                                supports_long_context)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

set_fp32_policy()

TOL = 2e-5
BATCH, SEQ = 2, 10
ROOT = Path(__file__).resolve().parents[1]
NEW_ARCHS = ["granite-3-2b", "granite-20b", "qwen1.5-4b", "qwen3-moe-30b-a3b",
             "grok-1-314b", "internvl2-26b"]


def _err(got, want) -> float:
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _with_biases(params, rs):
    """Random qkv biases (they are zero at init) in a reference param tree."""
    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif key in ("bq", "bk", "bv"):
                node[key] = (rs.standard_normal(val.shape) * 0.5).astype(val.dtype)
    walk(params)
    return params


def _state(jc, seed=0):
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(seed + 1)))
    rs = np.random.default_rng(seed)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    return jm, _with_biases(params, rs), lora, rs


def _batch(cfg, rs, b=BATCH, s=SEQ):
    out = {"tokens": rs.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rs.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rs.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    return out


def _cfgs(arch, **kw):
    return (j_reduced(J_REGISTRY[arch]).with_(**kw), reduced(REGISTRY[arch]).with_(**kw))


# ---------------------------------------------------------------- qkv biases

@pytest.mark.parametrize("impl", ["einsum", "fused"])
@pytest.mark.parametrize("grouped", [False, True])
def test_qkv_project_with_biases_matches_reference(impl, grouped):
    jc, tc = _cfgs("qwen1.5-4b")
    jc, tc = (c.with_(lora=dataclasses.replace(c.lora, impl=impl)) for c in (jc, tc))
    rs = np.random.default_rng(3)
    d, r = jc.d_model, jc.lora.rank
    p = {"wq": rs.standard_normal((d, jc.attn_dim)), "wk": rs.standard_normal((d, jc.kv_dim)),
         "wv": rs.standard_normal((d, jc.kv_dim)), "wo": rs.standard_normal((jc.attn_dim, d)),
         "bq": rs.standard_normal(jc.attn_dim), "bk": rs.standard_normal(jc.kv_dim),
         "bv": rs.standard_normal(jc.kv_dim)}
    p = {k: (v / np.sqrt(d) if k.startswith("w") else v).astype(np.float32)
         for k, v in p.items()}
    lead = (3,) if grouped else ()
    lora = {key: {"a": (rs.standard_normal(lead + (r, d)) * 0.1).astype(np.float32),
                  "b": (rs.standard_normal(lead + (n, r)) * 0.1).astype(np.float32)}
            for key, n in (("wq", jc.attn_dim), ("wk", jc.kv_dim), ("wv", jc.kv_dim))}
    x = rs.standard_normal((3 * BATCH if grouped else BATCH, SEQ, d)).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)
    want = JL.qkv_project(jc, _jtree(p), _jtree(lora), jnp.asarray(x), jnp.asarray(pos))
    got = L.qkv_project(tc, to_torch(p, "cpu"), to_torch(lora, "cpu"), torch.from_numpy(x),
                        torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL
    # the biases are in: without them the projections move by O(1)
    nob = {k: v for k, v in p.items() if not k.startswith("b")}
    q0 = L.qkv_project(tc, to_torch(nob, "cpu"), to_torch(lora, "cpu"), torch.from_numpy(x),
                       torch.from_numpy(pos))[0]
    assert _err(q0, want[0]) > 1e-2


def test_bias_dtype_order_follows_the_reference():
    """bf16 x against an f32 base with an f32 bias: the fused path adds the
    bias in the base's type and casts the sum to x's; the plain path casts
    the bias to x's type first."""
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.standard_normal((5, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.standard_normal((16, 8)).astype(np.float32))
    bias = torch.from_numpy(rs.standard_normal(8).astype(np.float32) * 1e3 + 0.3)
    lora = {"a": torch.zeros(2, 16), "b": torch.zeros(8, 2)}
    for impl in ("einsum", "fused"):
        jy = JL.lora_apply(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.numpy()),
                           _jtree({k: v.numpy() for k, v in lora.items()}), 2.0,
                           jnp.asarray(bias.numpy()), impl=impl)
        ty = L.lora_apply(x, w, lora, 2.0, bias, impl=impl)
        assert ty.dtype == torch.bfloat16
        np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))


# ---------------------------------------------------------------- the int8 KV cache

def test_quant_rows_bit_equal_to_reference():
    """The int8 cache's row quantizer on shared inputs, .5 ties and a zero
    row included: codes and scales bit for bit."""
    from repro.models import blocks as JB
    from repro_torch.models import blocks as B

    rs = np.random.default_rng(6)
    x = rs.standard_normal((3, 1, 4, 64)).astype(np.float32)
    x[0, 0, 1] = 0.0
    x[1, 0, 2, :4] = [127.0, 0.5, -1.5, 2.5]              # scale 1: exact ties
    x[1, 0, 2, 4:] = 0.0
    jq, js = JB._quant_rows(jnp.asarray(x))
    tq, ts = B._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma-2b"])
def test_int8_serve_steps_match_reference(arch):
    """Ten decode steps into an int8 cache (``kv_cache_dtype="int8"``) of
    qwen1.5-4b (MHA, qkv biases) and gemma-2b (MQA): after every step the
    cache's codes equal the reference's bit for bit, its scales and the
    logits within 1e-5 of their scale.  (The codes round K and V, which
    the two packages compute to within an ulp, so an element at a rounding
    boundary could round the other way; at these seeds none does.)"""
    jc, tc = _cfgs(arch, kv_cache_dtype="int8")
    jm, params, lora, rs = _state(jc)
    tm = build_model(tc, device="cpu")
    toks = rs.integers(0, jc.vocab_size, (BATCH, SEQ)).astype(np.int32)
    jp, jl = _jtree(params), _jtree(lora)
    tp, tl = to_torch(params, "cpu"), to_torch(lora, "cpu")
    jcache, tcache = jm.init_cache(BATCH, 16), tm.init_cache(BATCH, 16)
    assert tcache["k"].dtype == torch.int8 and tcache["k_scale"].dtype == torch.float32
    with torch.no_grad():
        for i in range(SEQ):
            jlog, jcache = jm.serve_step(jp, jl, jcache, jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i))
            tlog, tcache = tm.serve_step(tp, tl, tcache, torch.from_numpy(toks[:, i:i + 1]), i)
            assert _err(tlog, jlog) <= 1e-5
            for key in ("k", "v"):
                np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
                assert _err(tcache[key + "_scale"], jcache[key + "_scale"]) <= 1e-5


def test_int8_cache_decodes_every_family():
    """The MoE block decodes through the same int8 cache (its attention
    half is the dense block's): finite logits, and within the reference's
    bound (0.05 of the logits' scale, tests/test_fused_lora_integration.py)
    of the float cache's."""
    tc = reduced(REGISTRY["qwen3-moe-30b-a3b"])
    model, model_q = build_model(tc, device="cpu"), build_model(
        tc.with_(kv_cache_dtype="int8"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    toks = torch.randint(0, tc.vocab_size, (BATCH, SEQ), generator=torch.Generator().manual_seed(3))
    caches = [model.init_cache(BATCH, 16), model_q.init_cache(BATCH, 16)]
    with torch.no_grad():
        for i in range(SEQ):
            lf, caches[0] = model.serve_step(params, None, caches[0], toks[:, i:i + 1], i)
            lq, caches[1] = model_q.serve_step(params, None, caches[1], toks[:, i:i + 1], i)
            assert torch.isfinite(lq).all()
            assert float((lf - lq).abs().max() / lf.abs().max()) < 0.05


# ---------------------------------------------------------------- head and embedding

@pytest.mark.parametrize("knob", [{"tie_embeddings": False}, {"embed_impl": "onehot"}])
def test_untied_head_and_onehot_embedding_match_reference(knob):
    jc, tc = _cfgs("gemma-2b", **knob)
    jm, params, lora, rs = _state(jc)
    tm = build_model(tc, device="cpu")
    assert ("head" in params) == (knob.get("tie_embeddings") is False)
    tp = to_torch(params, "cpu")
    if "head" in params:
        assert tuple(tm.init_params(torch.Generator())["head"].shape) == params["head"].shape
    batch = _batch(jc, rs)
    jl, jlog = jm.loss(_jtree(params), _jtree(lora), _jtree(batch))
    with torch.no_grad():
        tl, tlog = tm.loss(tp, to_torch(lora, "cpu"), to_torch(batch, "cpu"))
        tpre, _ = tm.prefill(tp, to_torch(lora, "cpu"), to_torch({"tokens": batch["tokens"]},
                                                                  "cpu"))
    jpre, _ = jm.prefill(_jtree(params), _jtree(lora), {"tokens": jnp.asarray(batch["tokens"])})
    assert _err(tlog, jlog) <= TOL and _err(tl, jl) <= TOL and _err(tpre, jpre) <= TOL


# ---------------------------------------------------------------- every new config

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_reference(arch):
    """Loss and logits (the VLM's over its text positions), the prefill's
    last-position logits and caches, and two decode steps."""
    jc, tc = _cfgs(arch)
    jm, params, lora, rs = _state(jc)
    tm = build_model(tc, device="cpu")
    batch = _batch(jc, rs)
    jp, jl = _jtree(params), _jtree(lora)
    tp, tl = to_torch(params, "cpu"), to_torch(lora, "cpu")
    jloss, jlog = jm.loss(jp, jl, _jtree(batch))
    pre = {k: v for k, v in batch.items() if k != "targets"}
    jpre, jcache = jm.prefill(jp, jl, _jtree(pre))
    with torch.no_grad():
        # the reference's loss runs its scan path, which adds the MoE aux
        tloss, tlog = tm.loss(tp, tl, to_torch(batch, "cpu"), path="scan")
        tpre, tcache = tm.prefill(tp, tl, to_torch(pre, "cpu"))
    assert tuple(tlog.shape) == (BATCH, SEQ, jc.vocab_size)
    assert _err(tloss, jloss) <= TOL and _err(tlog, jlog) <= TOL and _err(tpre, jpre) <= TOL
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert _err(tcache[key], jcache[key]) <= TOL
    jc_cache, tc_cache = jm.init_cache(BATCH, 8), tm.init_cache(BATCH, 8)
    with torch.no_grad():
        for i in range(2):
            tok = batch["tokens"][:, i:i + 1]
            jd, jc_cache = jm.serve_step(jp, jl, jc_cache, jnp.asarray(tok), jnp.int32(i))
            td, tc_cache = tm.serve_step(tp, tl, tc_cache, torch.from_numpy(tok), i)
            assert _err(td, jd) <= TOL


def test_vlm_embed_loss_and_prefill_match_reference():
    """internvl2: the projected vision tokens precede the text, positions
    span both, the loss reads the text positions alone."""
    jc, tc = _cfgs("internvl2-26b")
    jm, params, lora, rs = _state(jc, seed=5)
    tm = build_model(tc, device="cpu")
    assert params["proj"].shape == (jc.vision_embed_dim, jc.d_model)
    batch = _batch(jc, rs, s=6)
    tp, tb = to_torch(params, "cpu"), to_torch(batch, "cpu")
    jx = jm.embed(_jtree(params), _jtree(batch))
    tx = tm.embed(tp, tb)
    assert tuple(tx.shape) == (BATCH, jc.n_vision_tokens + 6, jc.d_model)
    assert _err(tx, jx) <= TOL
    # without vision embeddings the VLM embeds text alone
    assert tuple(tm.embed(tp, {"tokens": tb["tokens"]}).shape) == (BATCH, 6, jc.d_model)
    jloss, jlog = jm.loss(_jtree(params), _jtree(lora), _jtree(batch))
    with torch.no_grad():
        tloss, tlog = tm.loss(tp, to_torch(lora, "cpu"), tb, path="scan")
        pre = {k: v for k, v in tb.items() if k != "targets"}
        tpre, tcache = tm.prefill(tp, to_torch(lora, "cpu"), pre)
    jpre, jcache = jm.prefill(_jtree(params), _jtree(lora),
                              _jtree({k: v for k, v in batch.items() if k != "targets"}))
    assert tuple(tlog.shape) == (BATCH, 6, jc.vocab_size)
    assert _err(tloss, jloss) <= TOL and _err(tlog, jlog) <= TOL and _err(tpre, jpre) <= TOL
    assert tcache["k"].shape[2] == jc.n_vision_tokens + 6
    assert _err(tcache["k"], jcache["k"]) <= TOL


def _same_config(a, b):
    """The port's config ``b`` equals the reference's ``a``; the fields only
    the port has sit at their defaults (as in tests/test_torch_copies.py)."""
    want, got = dataclasses.asdict(a), dataclasses.asdict(b)
    extra = {f.name: f.default for f in dataclasses.fields(b) if f.name not in want}
    assert {k: got.pop(k) for k in extra} == extra
    assert want == got


@pytest.mark.parametrize("arch", sorted(J_REGISTRY))
def test_long_context_rules_match_reference(arch):
    j, t = J_REGISTRY[arch], REGISTRY[arch]
    assert supports_long_context(t) == j_supports_long_context(j)
    for window in (8192, 1024):
        _same_config(j_long_context_variant(j, window), long_context_variant(t, window))


# ---------------------------------------------------------------- the port's own rules

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_build_model_builds_every_ported_family(arch):
    """Every registered config builds and inits (reduced, on the CPU; on
    the meta device at full size), the hybrid and encdec families
    included; the encoder-decoder stacks its layers under ``enc_layers``
    and ``dec_layers``."""
    cfg = REGISTRY[arch]
    model = build_model(reduced(cfg), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    stacks = ("enc_layers", "dec_layers") if cfg.family == "encdec" else ("layers",)
    assert all(params[k] for k in stacks) and all(torch.isfinite(x.float()).all()
                                                  for x in tree_leaves(params))
    full = build_model(cfg, device="meta").init_params(None)
    n = sum(x.numel() for x in tree_leaves(full))
    # the analytic counts of these families are rounded (the hybrid's and
    # encdec's full-size trees are held against the reference's leaf by leaf
    # in tests/test_torch_encdec.py)
    if cfg.family not in ("ssm", "encoder", "hybrid", "encdec"):
        assert abs(n - cfg.param_count()) <= 1e-4 * n


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-moe-30b-a3b", "internvl2-26b"])
def test_stacked_init_equals_the_list_of_layers(arch):
    """``init_params`` fills the stacked layers in place; at the same seed
    its values equal the per-layer list stacked afterwards, bit for bit."""
    cfg = reduced(REGISTRY[arch], n_layers=3).with_(dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    got = model.init_params(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    dt = L.torch_dtype(cfg.dtype)
    want = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, "cpu"),
            "layers": stack_trees([model.block["init"](gen, cfg, "cpu")
                                   for _ in range(cfg.n_layers)])}
    if cfg.family == "vlm":
        want["proj"] = L.dense_init(gen, cfg.vision_embed_dim, cfg.d_model, dt, "cpu")
    for a, b in zip(tree_leaves({k: got[k] for k in want}), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bridge_carries_moe_vlm_and_bias_leaves_bit_for_bit():
    """A bf16 model's 3-D expert stacks, its f32 router, the qkv biases and
    the VLM projector come across in their types, bit for bit."""
    for arch in ("qwen3-moe-30b-a3b", "qwen1.5-4b", "internvl2-26b"):
        jc = j_reduced(J_REGISTRY[arch]).with_(dtype="bfloat16")
        params = jax.tree.map(np.asarray, j_build(jc).init_params(jax.random.PRNGKey(0)))
        _with_biases(params, np.random.default_rng(1))
        got = to_torch(params, "cpu")
        layers = got["layers"]
        if arch == "qwen3-moe-30b-a3b":
            assert layers["experts"]["we_u"].dtype == torch.bfloat16
            assert layers["experts"]["we_u"].dim() == 4      # (L, E, d, ff)
            assert layers["wr_router"].dtype == torch.float32
        if arch == "qwen1.5-4b":
            assert layers["attn"]["bq"].dtype == torch.float32
            assert float(layers["attn"]["bq"].abs().max()) > 0
        if arch == "internvl2-26b":
            assert got["proj"].dtype == torch.bfloat16
        flat_j, flat_t = [], []

        def walk(j, t):
            if isinstance(j, dict):
                for k in j:
                    walk(j[k], t[k])
            else:
                flat_j.append(np.asarray(j))
                flat_t.append(t)

        walk(params, got)
        for j, t in zip(flat_j, flat_t):
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), j)


def test_launch_defaults_to_granite_3_2b():
    """``python -m repro_torch.launch.train`` without ``--arch`` trains the
    reference's default, granite-3-2b (reduced here, on the CPU)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c",
                           "import sys; from repro_torch.launch import train; "
                           "sys.argv[1:] = ['--mode', 'central', '--reduced', '--steps', '1', "
                           "'--batch', '2', '--seq', '16', '--log-every', '1', "
                           "'--device', 'cpu']; "
                           "import repro_torch.configs as c; got = []; "
                           "orig = c.get_config; train.get_config = "
                           "lambda name: got.append(name) or orig(name); train.main(); "
                           "print('ARCH', got)"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ARCH ['granite-3-2b']" in proc.stdout and "final loss" in proc.stdout
