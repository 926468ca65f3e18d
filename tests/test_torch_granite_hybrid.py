"""granite-4.0-h-micro, the per-layer hybrid (a Mamba2 or an attention
mixer a layer, each with its own MLP, and Granite's multipliers), on the
CPU at the size ``configs.reduced`` gives it, in float32 from seeded
random weights: the port's loss, adapter gradients and ``dv`` of
``splitfl.make_server_step`` at cuts below and above the attention layer,
and ``forward_hidden`` on the sliced and scan paths, against the plain
reference ``tests/plain_granite_hybrid.py`` (which imports nothing of the
port).  Beside them: the reference's quadratic SSD against its own
recurrence, the SSD's recompute under grad bit for bit, the multipliers
at their defaults adding no operation, the parameter count, the memory
model by mixer kind, the spans, the error of prefill and decode, and on a
card the flash pair at the attention multiplier."""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import plain_granite_hybrid as ref
from repro_torch.configs import REGISTRY, reduced
from repro_torch.core import memory_model, splitfl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention_apply
from repro_torch.models import blocks as B
from repro_torch.models import build_model
from repro_torch.obs import wall
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "granite-4.0-h-micro"
N_LAYERS, SEQ, CHUNK = 5, 24, 8          # three SSD chunks: the carried state is used
CUTS = (1, 3)                            # below and above the attention layer (2)


def _cfg():
    cfg = reduced(REGISTRY[ARCH], n_layers=N_LAYERS, d_model=64).with_(wkv_chunk=CHUNK)
    assert cfg.layer_types == ("mamba", "mamba", "attention", "mamba", "mamba")
    assert cfg.dtype == "float32" and cfg.attention_multiplier == 0.015625
    return cfg


def _mc(cfg):
    """The reference's configuration dict from the port's config."""
    s = cfg.ssm
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "layer_types": list(cfg.layer_types),
            "ssm": {"d_state": s.d_state, "d_conv": s.d_conv, "expand": s.expand,
                    "head_dim": s.head_dim},
            "embedding_multiplier": cfg.embedding_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "lora": {"rank": cfg.lora.rank, "alpha": cfg.lora.alpha}}


def _randomized(tree, gen, scale):
    return tree_map(lambda t: t + scale * torch.randn(t.shape, generator=gen), tree)


@pytest.fixture(scope="module")
def setup():
    """The reduced model with every weight drawn (the norms, conv bias, dt
    bias and skip away from their init values, so that each enters the
    result), adapters with a nonzero B, one upload."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    for key in ("layers", "mamba"):
        params[key] = {k: (_randomized(v, gen, 0.1) if k in ("ln1", "ln2", "norm", "conv_b",
                                                              "dt_bias", "d_skip") else v)
                       for k, v in params[key].items()}
    params["final_norm"] = _randomized(params["final_norm"], gen, 0.1)
    lora = _randomized(model.init_lora(gen), gen, 0.05)
    v = torch.randn(2, SEQ, cfg.d_model, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, SEQ + 1), generator=gen)
    batch = {"tokens": ids[:, :SEQ], "targets": ids[:, 1:]}
    return cfg, model, params, lora, v, batch


def _flat(model, lora, lo=0):
    """The port's adapter tree as the reference's flat leaves, each layer's
    own mixer's alone."""
    out = {}
    for i in range(lo, model.cfg.n_layers):
        key = model.mixers[i][0]
        for t, ad in lora["layers"][key].items():
            for ab in ("a", "b"):
                out[f"L{i}.{t}.{ab}"] = ad[ab][i]
    return out


def _rel(got, want):
    return float((got - want).detach().norm() / want.detach().norm())


# ------------------------------------------------------------------ the reference's SSD

def test_reference_quadratic_ssd_matches_its_recurrence():
    gen = torch.Generator().manual_seed(1)
    b, s, h, p, n = 2, 19, 3, 4, 5
    x, bm, cm = (torch.randn(sh, generator=gen) for sh in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a, d = -torch.rand(h, generator=gen) * 4 - 0.5, torch.randn(h, generator=gen)
    got = ref.ssd(x, bm, cm, dt, a, d)
    want = ref.ssd_recurrence(x, bm, cm, dt, a, d)
    # float32 sums in two orders over 19 steps: rounding, a few ulps of the values
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------------------------ the SSD's recompute

@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_ssd_recompute_under_grad_is_bit_equal(impl):
    """``ssd_apply`` under grad recomputes the SSD in its backward; its
    output and every input's gradient equal the plain form's bit for bit,
    and autograd holds none of the SSD's own tensors."""
    cfg = _cfg().with_(wkv_impl=impl)
    gen = torch.Generator().manual_seed(2)
    b, s, h, p, n = 2, SEQ, 4, 8, 16
    leaves = [torch.randn(sh, generator=gen).requires_grad_(True)
              for sh in ((b, s, h, p), (b, s, n), (b, s, n))]
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen)).requires_grad_(True)
    a_log, d_skip = torch.randn(h, generator=gen), torch.randn(h, generator=gen)
    state = torch.zeros(b, h, p, n)
    gy = torch.randn(b, s, h, p, generator=gen)
    plain = B.ssd_chunked if impl == "chunked" else B.ssd_scan
    kw = {"chunk": CHUNK} if impl == "chunked" else {}
    inputs = [*leaves, dt]

    def run(fn):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            y, _ = fn()
        return y, torch.autograd.grad(y, inputs, gy), saved

    y0, g0, saved0 = run(lambda: plain(*inputs, a_log, d_skip, state, **kw))
    y1, g1, saved1 = run(lambda: B.ssd_apply(cfg, *inputs, a_log, d_skip, state))
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(saved1) < len(saved0)
    ids = {id(t) for t in (*inputs, a_log, d_skip, state)}
    assert all(id(t) in ids for t in saved1)


# ------------------------------------------------------------------ the model against the reference

# Float32 on both sides, with TF32 off; the port's SSD sums chunk by chunk
# and carries a state where the reference forms the whole quadratic form,
# the port's conv is a loop of shifted products where the reference calls
# conv1d, and the port's attention groups heads where the reference
# repeats them: every gap is rounding in another order (2e-6 on the hidden
# states and dv, up to 1.3e-5 on the worst adapter leaf).  1e-4 leaves that
# room and no more: the residual multiplier left out reads 0.89.
TOL = 1e-4


@pytest.mark.parametrize("path", ["sliced", "scan", "scan_remat"])
def test_forward_hidden_matches_reference(setup, path):
    cfg, model, params, lora, _, batch = setup
    kw = {"path": "scan", "remat": True} if path == "scan_remat" else {"path": path}
    h, _ = model.forward_hidden(params, lora, batch, **kw)
    want = ref.forward(_mc(cfg), params, _flat(model, lora), batch["tokens"])
    assert _rel(h, want) <= TOL


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("path", ["sliced", "scan"])
def test_server_step_matches_reference(setup, cut, path):
    """The step's loss, each adapter leaf's gradient (read back from
    AdamW's first moment) and ``dv`` against the reference's step; layers
    below the cut get no gradient."""
    cfg, model, params, lora, v, batch = setup
    opt = AdamW(1e-3)
    if path == "sliced":
        step = splitfl.make_server_step(model, opt, path="sliced", static_cut=cut)
        loss, _, state, dv = step(params, lora, opt.init(lora), v, batch)
    else:
        step = splitfl.make_server_step(model, opt, path="scan")
        loss, _, state, dv = step(params, lora, opt.init(lora), v, batch, torch.tensor(cut))
    want_loss, want_dv, want_g, _ = ref.server_step(_mc(cfg), params, _flat(model, lora, cut),
                                                    v, batch["targets"], cut, lr=1e-3)
    assert abs(float(loss) - float(want_loss)) <= TOL * abs(float(want_loss))
    assert _rel(dv, want_dv) <= TOL
    grads = _flat(model, tree_map(lambda m: m / (1 - opt.b1), state.mu))
    for name, g in grads.items():
        if int(name.split(".")[0][1:]) < cut:
            assert not g.any(), name
        else:
            assert _rel(g, want_g[name]) <= TOL, name


def test_split_round_matches_the_references_full_gradient(setup):
    """Eq. 9 on the hybrid: the client's truncated stack (its norms and
    MLPs cut at 3, the mixer stacks whole) and its adapters from
    ``split_lora`` give v; the server step gives dv; the client's pullback
    of dv gives its adapters' gradients.  Client and server gradients
    together equal the reference's gradient of the full loss from the
    tokens (the embedding multiplier on the client's side)."""
    from repro_torch.core import lora as lora_lib
    cfg, model, params, lora, _, batch = setup
    cut = 3
    pc = dict(params, layers=lora_lib.slice_stack(params["layers"], 0, cut))
    lc, ls = lora_lib.split_lora(lora, cut)
    v, pull = splitfl.client_forward_with_vjp(model, pc, lc, batch, cut)
    opt = AdamW(1e-3)
    server = lora_lib.embed_in_full_shape(ls, lora, cut, "server")
    step = splitfl.make_server_step(model, opt, static_cut=cut)
    _, _, state, dv = step(params, server, opt.init(server), v, batch)
    got = {**_flat(model, lora_lib.embed_in_full_shape(pull(dv), lora, cut, "client")),
           **_flat(model, tree_map(lambda m: m / (1 - opt.b1), state.mu), cut)}
    flat = _flat(model, lora)
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in flat.items()}
    with torch.enable_grad():
        h = ref.forward(_mc(cfg), params, leaves, batch["tokens"])
        loss = ref.lm_loss(_mc(cfg), params, h, batch["targets"])
        want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for name, g in want.items():
        assert _rel(got[name], g) <= TOL, name


# ------------------------------------------------------------------ multipliers at their defaults

class _Ops(TorchDispatchMode):
    """The aten ops a call dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _dense_step(cfg, **over):
    model = build_model(cfg.with_(**over), device="cpu")
    gen = torch.Generator().manual_seed(3)
    params, lora = model.init_params(gen), _randomized(model.init_lora(gen), gen, 0.05)
    v = torch.randn(2, 8, cfg.d_model, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    opt = AdamW(1e-3)
    step = splitfl.make_server_step(model, opt, static_cut=1)
    with _Ops() as rec:
        out = step(params, lora, opt.init(lora), v, {"tokens": ids[:, :8], "targets": ids[:, 1:]})
        logits = model.unembed(params, model.embed(params, {"tokens": ids}))
    loss, new_lora, state, dv = out
    return [loss, *tree_leaves(new_lora), *tree_leaves(state.mu), *tree_leaves(state.nu), dv,
            logits], rec.ops


def test_default_multipliers_add_no_operation(monkeypatch):
    """A granite-3-2b-shaped step with the new fields at their defaults
    gives the same bits and dispatches the same ops as the step whose
    residual adds are the plain ``x + o`` they were before the fields
    (the embedding, logits and softmax scale at their defaults take the
    old code's own lines); a residual multiplier other than 1 adds ops."""
    cfg = reduced(REGISTRY["granite-3-2b"], n_layers=3, d_model=64)
    got, ops = _dense_step(cfg)
    monkeypatch.setattr(B, "_residual", lambda c, x, o: x + o)
    want, want_ops = _dense_step(cfg)
    assert ops == want_ops
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    monkeypatch.undo()
    _, more = _dense_step(cfg, residual_multiplier=0.5, embedding_multiplier=2.0,
                          logits_scaling=4.0)
    assert len(more) > len(ops)


# ------------------------------------------------------------------ counts, memory, spans, errors

def test_param_count_equals_the_spec_at_full_width():
    cfg = REGISTRY[ARCH]
    model = build_model(cfg, device="meta")
    spec = model.params_spec()
    n = sum(x.numel() for x in tree_leaves(spec))
    assert n == cfg.param_count() == 3_191_396_096
    assert spec["mamba"]["in_proj"].shape == (36, 2048, 8512)
    assert spec["mamba"]["out_proj"].shape == (36, 4096, 2048)
    assert spec["attn"]["wk"].shape == (4, 2048, 512)
    assert spec["layers"]["mlp"]["wu"].shape == (40, 2048, 8192)
    assert spec["embed"].shape == (100_352, 2048) and "head" not in spec


def test_memory_model_counts_each_layer_by_its_kind():
    """The server's bytes by layer: a Mamba2 layer and an attention layer
    as their own weights and their own mixer's adapters, the whole model as
    its spec, and the sfl/sl submodels as the layers past each cut."""
    cfg = REGISTRY[ARCH]
    mb = memory_model.model_bytes(cfg)
    model = build_model(cfg, device="meta")
    spec = model.params_spec()
    lspec = model.lora_spec()["layers"]
    size = lspec["mamba"]["in_proj"]["a"].element_size()
    # r 16 on in_proj 2048 -> 8512 and out_proj 4096 -> 2048; on wq, wk, wv, wo
    ada_m, ada_a = 16 * (2048 + 8512 + 4096 + 2048) * size, 16 * (4 * 2048 + 2 * 2560) * size
    assert memory_model.tree_bytes(lspec) == 40 * (ada_m + ada_a)
    assert mb.lora_layers(5, 6) == ada_a and mb.lora_layers(0, 3) == 3 * ada_m
    assert mb.lora() == 36 * ada_m + 4 * ada_a
    lora_3 = 3 * ada_m
    assert (memory_model.client_memory(cfg, 3, 16, 512) - memory_model.client_memory(cfg, 0, 16, 512)
            == mb.layers(0, 3) + lora_3 + memory_model.optimizer_bytes(lora_3)
            + memory_model.activation_bytes_training(cfg, 3, 16, 512)
            - memory_model.activation_bytes_training(cfg, 0, 16, 512))
    assert mb.params() == memory_model.tree_bytes(spec)
    common = memory_model.tree_bytes(spec["layers"]) // 40
    mamba = memory_model.tree_bytes(spec["mamba"]) // 36
    attn = memory_model.tree_bytes(spec["attn"]) // 4
    assert mb.layers(5, 6) == common + attn and mb.layers(4, 5) == common + mamba
    assert mb.layers(3, 40) == 37 * common + 33 * mamba + 4 * attn
    sl = memory_model.server_memory(cfg, "sl", [3, 7], 16, 512)
    assert sl.params == mb.layers(3, 40) + mb.head
    sfl = memory_model.server_memory(cfg, "sfl", [3, 7], 16, 512)
    assert sfl.params == mb.layers(3, 40) + mb.layers(7, 40) + 2 * mb.head


def test_spans_of_the_mixers_and_their_backward(setup):
    """Under a profiler the step records a ``mamba`` span a Mamba2 layer
    with an ``ssd`` span inside it, ``attention`` in the attention layer,
    two norms and an MLP a layer, each with its ``.bwd`` bracket; the
    SSD's recompute in the backward records none."""
    cfg, model, params, lora, v, batch = setup
    opt = AdamW(1e-3)
    step = splitfl.make_server_step(model, opt, static_cut=1)
    wall.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, lora, opt.init(lora), v, batch)
    spans = wall.recorded()
    wall.reset()
    count = {}
    for s in spans:
        count[s.name] = count.get(s.name, 0) + 1
    layers = N_LAYERS - 1
    assert count == {"server_step": 1, "forward": 1, "backward": 1, "optimizer": 1,
                     "lm_head": 1, "lm_head.bwd": 1, "norm": 2 * layers,
                     "norm.bwd": 2 * layers, "mlp": layers, "mlp.bwd": layers,
                     "mamba": 3, "mamba.bwd": 3, "ssd": 3, "ssd.bwd": 3,
                     "attention": 1, "attention.bwd": 1}
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == "mamba" for s in spans if s.name == "ssd")
    assert all(by_id[s.parent].name == "mamba.bwd" for s in spans if s.name == "ssd.bwd")


def test_prefill_and_decode_raise_naming_the_roadmap_item(setup):
    _, model, params, lora, _, batch = setup
    for call in (lambda: model.prefill(params, lora, batch),
                 lambda: model.init_cache(1, 8),
                 lambda: model.serve_step(params, lora, None, batch["tokens"][:, :1], 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP F.5"):
            call()


def test_layer_types_must_fit_the_stack():
    cfg = REGISTRY[ARCH]
    with pytest.raises(ValueError, match="layer_types"):
        cfg.with_(n_layers=39)
    with pytest.raises(ValueError, match="layer_types"):
        REGISTRY["granite-3-2b"].with_(layer_types=("mamba",) * 40)


# ------------------------------------------------------------------ the softmax scale

def test_plain_pair_takes_the_attention_multiplier():
    """The flash pair's plain versions at a scale other than 1/sqrt(D)
    against the materialised softmax at that scale, forward and backward."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(2, 12, 4, 16, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 12, 2, 16, generator=gen, requires_grad=True) for _ in range(2))
    pos = torch.arange(12)
    got = flash_attention_apply(q, k, v, causal=True, scale=0.015625)
    want = B.L.attention_full(q, k, v, causal=True, window=None, q_pos=pos, k_pos=pos,
                              scale=0.015625)
    gout = torch.randn(got.shape, generator=gen)
    g_got = torch.autograd.grad(got, (q, k, v), gout)
    g_want = torch.autograd.grad(want, (q, k, v), gout)
    # float32, the same products in another grouping
    assert _rel(got, want) <= 1e-5
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(g_got, g_want))
    default = B.L.attention_full(q, k, v, causal=True, window=None, q_pos=pos, k_pos=pos)
    assert _rel(default, want) > 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cuda_pair_at_the_attention_multiplier(cuda_device):
    """On the card, at granite-4.0-h-micro's attention shape (16 x 512, 32
    heads on 8 of 64) and its multiplier 1/64: the normalise-first forward
    per row within 1e-2 of its plain version (bf16's rounding of p, as at
    1/sqrt(D)), the lse within 1e-5, and dq, dk, dv within 5e-4 over the
    tensor (the flash tests' GRAD_REL_TOL); 1/sqrt(D) given as a number
    gives the bits of the default."""
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn(shp, generator=g, device="cuda").bfloat16()
                   for shp in ((16, 512, 32, 64), (16, 512, 8, 64), (16, 512, 8, 64),
                               (16, 512, 32, 64)))
    scale = REGISTRY[ARCH].attention_multiplier
    out, lse = fa.flash_attention(q, k, v, causal=True, normalize_first=True,
                                  return_lse=True, scale=scale)
    want, lse_want = fa.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                        return_lse=True, scale=scale)
    assert float((lse.cpu() - lse_want).abs().max()) <= 1e-5
    rows = ((out.float().cpu() - want.float()).norm(dim=-1)
            / want.float().norm(dim=-1).clamp_min(1e-30))
    assert float(rows.max()) <= 1e-2
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True, scale=scale)
    plain = fa.flash_attention_bwd(*(x.cpu() for x in (q, k, v, out, do, lse)), causal=True,
                                   scale=scale)
    for a, b in zip(got, plain):
        assert _rel(a.float().cpu(), b.float()) <= 5e-4
    d = fa.flash_attention(q, k, v, causal=True, normalize_first=True)
    assert torch.equal(d, fa.flash_attention(q, k, v, causal=True, normalize_first=True,
                                             scale=1.0 / math.sqrt(64)))
