"""The launch layer's step constructors in the port against the JAX package's,
on reduced configs (2 layers, d 256, fp32) at a 2 x 32 shape, from the
reference's own initial params, adapters and AdamW state (bridged) and
numpy-seeded inputs: ``build_step`` for train, prefill and decode on six
families where ``should_skip`` allows; gradient accumulation over
``policy.microbatch``; remat on against off; ``build_server_resume_step``
at two cuts from one step; the sharded MoE with token chunks.  The
reference runs on a 1 x 1 mesh of ``Auto`` axes (jax's ``make_mesh`` now
defaults to ``Explicit`` axes, under which its ``hidden_constraint``
raises).

Tolerances: losses and logits within 1e-5 relative; caches within 1e-4;
gradients (read from AdamW's first moment, mu = (1 - b1) g after one
step) within 1e-5 of the tensor's scale; adapters after the update within
2*lr per element (ROADMAP Queue C: an element whose gradient is near zero
may move by lr the other way under any reordering of its sum).
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

from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, get_shape, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.sharding import ShardingPolicy  # noqa: E402
from repro_torch.launch.steps import build_server_resume_step, build_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

set_fp32_policy()

LR = 1e-3
BATCH, SEQ = 2, 32
ARCHS = ("granite-3-2b", "qwen3-moe-30b-a3b", "rwkv6-3b", "internvl2-26b",
         "whisper-large-v3", "zamba2-7b")
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
CASES = [(arch, kind) for arch in ARCHS for kind in KINDS
         if dryrun.should_skip(arch, KINDS[kind]) is None]


class _Ref:
    """The JAX package's pieces these tests hold the port against."""

    def __init__(self):
        self.jax = pytest.importorskip("jax")
        import jax.numpy as jnp
        from jax.sharding import AxisType

        from repro.configs import REGISTRY as J_REGISTRY
        from repro.configs import reduced as j_reduced
        from repro.launch import sharding, steps
        from repro.models import build_model as j_build
        from repro.optim import AdamW as JAdamW

        self.jnp, self.steps, self.sharding = jnp, steps, sharding
        self.registry, self.reduced, self.build, self.AdamW = (J_REGISTRY, j_reduced,
                                                                j_build, JAdamW)
        self.mesh = self.jax.make_mesh((1, 1), ("data", "model"),
                                       axis_types=(AxisType.Auto,) * 2)

    def tree(self, tree):
        return self.jax.tree.map(self.jnp.asarray, tree)

    def numpy(self, tree):
        return self.jax.tree.map(np.asarray, tree)

    def run(self, bundle, *args):
        with self.mesh:
            return bundle.fn(*args)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


@pytest.fixture(scope="module")
def mesh():
    return make_production_mesh(device="cpu")


def _cfgs(ref, arch, layers=2, **kw):
    return (ref.reduced(ref.registry[arch], n_layers=layers).with_(**kw),
            reduced(REGISTRY[arch], n_layers=layers).with_(**kw))


def _shape(kind, batch=BATCH, seq=SEQ):
    return dataclasses.replace(get_shape(KINDS[kind]), seq_len=seq, global_batch=batch)


def _state(ref, jcfg, seed=0):
    """The reference's params and adapters (B made non-zero, so the
    adapters move the output), as numpy."""
    jm = ref.build(jcfg)
    params = ref.numpy(jm.init_params(ref.jax.random.PRNGKey(seed)))
    lora = ref.numpy(jm.init_lora(ref.jax.random.PRNGKey(seed + 1)))
    rs = np.random.default_rng(seed)
    lora = ref.jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype),
                            lora)
    return params, lora


def _fill(spec_shape, dtype, cfg, rs, scale=1.0):
    if np.issubdtype(dtype, np.integer):
        return rs.integers(0, cfg.vocab_size, spec_shape).astype(dtype)
    return (rs.standard_normal(spec_shape) * scale).astype(dtype)


def _inputs(ref, jbundle, cfg, seed=3):
    """numpy inputs of the reference bundle's batch (or cache and token)
    stand-ins, made from a seed."""
    rs = np.random.default_rng(seed)
    return ref.jax.tree.map(lambda s: _fill(s.shape, np.dtype(s.dtype), cfg, rs, 0.5),
                            jbundle.args[-1] if jbundle.name != "serve_step"
                            else jbundle.args[2:4])


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1e-30, float(np.abs(want).max()))


def _leaves(tree):
    """(path, leaf) pairs in key order, for the port's dicts and the
    reference's key-sorted trees alike."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", x) for i, v in enumerate(tree) for p, x in _leaves(v)]
    return [("", tree)]


def _hold_trees(got, want, *, rel=None, atol=None):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, path
        if rel is not None:
            assert _rel(a, b) <= rel, (path, _rel(a, b))
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


def _hold_update(tl, topt, jl, jopt, lr=LR):
    """The new adapters within 2*lr; the gradients (mu / (1 - b1)) within
    1e-5 of each leaf's scale."""
    _hold_trees(tl, jl, atol=2 * lr)
    _hold_trees(topt.mu, jopt.mu, rel=1e-5)
    assert int(topt.step) == int(jopt.step) == 1


def _train_pair(ref, mesh, jcfg, tcfg, shape, policy=ShardingPolicy(), remat=True):
    jb = ref.steps.build_step(jcfg, shape, ref.mesh, ref.steps.ShardingPolicy(
        **dataclasses.asdict(policy)), lr=LR, remat=remat)
    tb = build_step(tcfg, shape, mesh, policy, lr=LR, remat=remat)
    params, lora = _state(ref, jcfg)
    batch = _inputs(ref, jb, jcfg)
    jopt = ref.AdamW(LR).init(ref.tree(lora))
    jout = ref.run(jb, ref.tree(params), ref.tree(lora), jopt, ref.tree(batch))
    tp, tl, tbatch = (to_torch(x, "cpu") for x in (params, lora, batch))
    return jout, tb.fn(tp, tl, to_torch(ref.numpy(jopt), "cpu"), tbatch)


@pytest.mark.parametrize("arch,kind", CASES)
def test_build_step_matches_reference(ref, mesh, arch, kind):
    jcfg, tcfg = _cfgs(ref, arch)
    shape = _shape(kind)
    if kind == "train":
        (jloss, jl, jo), (tloss, tl, to) = _train_pair(ref, mesh, jcfg, tcfg, shape)
        assert _rel(tloss, jloss) <= 1e-5
        _hold_update(tl, to, ref.numpy(jl), ref.numpy(jo))
        return
    jb = ref.steps.build_step(jcfg, shape, ref.mesh)
    tb = build_step(tcfg, shape, mesh)
    params, lora = _state(ref, jcfg)
    tp, tl = to_torch(params, "cpu"), to_torch(lora, "cpu")
    if kind == "prefill":
        batch = _inputs(ref, jb, jcfg)
        jlog, jcache = ref.run(jb, ref.tree(params), ref.tree(lora), ref.tree(batch))
        tlog, tcache = tb.fn(tp, tl, to_torch(batch, "cpu"))
    else:
        cache, token = _inputs(ref, jb, jcfg)
        pos = tb.args[4]                 # the cache's last slot
        jlog, jcache = ref.run(jb, ref.tree(params), ref.tree(lora), ref.tree(cache),
                               ref.tree(token), ref.jnp.int32(pos))
        tlog, tcache = tb.fn(tp, tl, to_torch(cache, "cpu"), to_torch(token, "cpu"), pos)
    assert tlog.shape == jlog.shape
    assert _rel(tlog, np.asarray(jlog)) <= 1e-5
    _hold_trees(tcache, ref.numpy(jcache), atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
def test_microbatch_accumulation_matches_reference(ref, mesh, arch):
    """policy.microbatch = 2 on a batch of 4: two micro-batches in turn,
    their gradients summed and halved before one AdamW update."""
    jcfg, tcfg = _cfgs(ref, arch)
    policy = ShardingPolicy(microbatch=2)
    (jloss, jl, jo), (tloss, tl, to) = _train_pair(ref, mesh, jcfg, tcfg,
                                                      _shape("train", batch=4), policy)
    assert _rel(tloss, jloss) <= 1e-5
    _hold_update(tl, to, ref.numpy(jl), ref.numpy(jo))


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b"])
def test_remat_is_bit_for_bit(mesh, arch):
    """Recomputing each layer in the backward changes no bit of the loss,
    the gradients or the new adapters."""
    cfg = reduced(REGISTRY[arch])
    shape = _shape("train")
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params, lora = model.init_params(gen), model.init_lora(gen)
    lora = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.05, lora)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "targets")}
    outs = []
    for remat in (False, True):
        b = build_step(cfg, shape, mesh, lr=LR, remat=remat)
        outs.append(b.fn(params, lora, AdamW(LR).init(lora), batch))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1:]), tree_leaves(outs[1][1:])):
        assert torch.equal(a, b)


def test_server_resume_step_two_cuts_match_reference(ref, mesh):
    """One server-resume step serves cuts 1 and 3 of a 4-layer model: loss,
    dv and the new adapters against the reference's one executable."""
    jcfg, tcfg = _cfgs(ref, "granite-3-2b", layers=4)
    jb = ref.steps.build_server_resume_step(jcfg, ref.mesh, batch=BATCH, seq_len=SEQ, lr=LR)
    tb = build_server_resume_step(tcfg, mesh, batch=BATCH, seq_len=SEQ, lr=LR)
    params, lora = _state(ref, jcfg)
    rs = np.random.default_rng(5)
    v = (rs.standard_normal((BATCH, SEQ, jcfg.d_model)) * 0.5).astype(np.float32)
    batch = {k: rs.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "targets")}
    jopt = ref.AdamW(LR).init(ref.tree(lora))
    tp, tl, tv, tbatch = (to_torch(x, "cpu") for x in (params, lora, v, batch))
    topt = to_torch(ref.numpy(jopt), "cpu")
    losses = []
    for cut in (1, 3):
        jloss, jl, jo, jdv = ref.run(jb, ref.tree(params), ref.tree(lora), jopt,
                                     ref.tree(v), ref.tree(batch), ref.jnp.int32(cut))
        tloss, tl2, to2, tdv = tb.fn(tp, tl, topt, tv, tbatch,
                                     torch.tensor(cut, dtype=torch.int32))
        assert _rel(tloss, jloss) <= 1e-5 and tdv.shape == v.shape
        assert _rel(tdv, np.asarray(jdv)) <= 1e-5
        _hold_update(tl2, to2, ref.numpy(jl), ref.numpy(jo))
        losses.append(float(tloss))
    assert losses[0] != losses[1]


@pytest.mark.parametrize("chunks", [1, 2])
def test_sharded_moe_matches_reference(ref, mesh, chunks):
    """qwen3-moe under policy.moe_shard_map, the tokens in one dispatch or
    in two token blocks: loss and adapter gradients against the
    reference's shard_map on its 1 x 1 mesh."""
    jcfg, tcfg = _cfgs(ref, "qwen3-moe-30b-a3b", moe_token_chunks=chunks)
    policy = ShardingPolicy(moe_shard_map=True)
    (jloss, jl, jo), (tloss, tl, to) = _train_pair(ref, mesh, jcfg, tcfg,
                                                      _shape("train"), policy)
    assert _rel(tloss, jloss) <= 1e-5
    _hold_update(tl, to, ref.numpy(jl), ref.numpy(jo))


def test_sharded_moe_equals_moe_mlp_at_one_group(mesh):
    """The sharded form is ``moe_mlp`` with ``moe_token_chunks`` groups, bit
    for bit: one token block is one group over every token, two blocks are
    two groups (each its own capacity and aux loss); the dense fallback
    (decode) never takes the sharded form."""
    cfg = reduced(REGISTRY["qwen3-moe-30b-a3b"])
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    p = tree_map(lambda a: a[0], model.init_params(gen)["layers"])
    lora = tree_map(lambda a: a[0], model.init_lora(gen)["layers"])
    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)
    ctx = model.make_ctx(SEQ, "cpu")
    want = B.moe_mlp(cfg, p, lora, x, ctx)
    got = B.moe_mlp(cfg, p, lora, x, dict(ctx, moe_mesh=mesh))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want2 = B.moe_mlp(cfg, p, lora, x, dict(ctx, moe_groups=2))
    two = B.moe_mlp(cfg.with_(moe_token_chunks=2), p, lora, x, dict(ctx, moe_mesh=mesh))
    assert torch.equal(two[0], want2[0]) and torch.equal(two[1], want2[1])
    assert not torch.equal(two[1], want[1])
    # moe_mlp itself does not read moe_token_chunks
    plain2 = B.moe_mlp(cfg.with_(moe_token_chunks=2), p, lora, x, ctx)
    assert torch.equal(plain2[0], want[0]) and torch.equal(plain2[1], want[1])
    dense = B.moe_mlp(cfg, p, lora, x, dict(ctx, moe_mesh=mesh, moe_dense_fallback=True))
    assert torch.equal(dense[0], B.moe_mlp(cfg, p, lora, x,
                                           dict(ctx, moe_dense_fallback=True))[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_build_step_runs_flash(cuda_device):
    """On the card: the one-card mesh on cuda:0, and a reduced bf16
    gemma-2b prefill step (attn_impl "chunked") that launches flash once a
    layer; its train step runs and its loss is finite."""
    mesh = make_production_mesh()
    assert mesh.device == torch.device("cuda", 0) and mesh.shape == {"data": 1, "model": 1}
    cfg = reduced(REGISTRY["gemma-2b"]).with_(dtype="bfloat16", attn_impl="chunked")
    gen = torch.Generator(device=cuda_device)
    model = build_model(cfg, cuda_device)
    params, lora = model.init_params(gen.manual_seed(0)), model.init_lora(gen.manual_seed(1))
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=gen,
                              device=cuda_device, dtype=torch.int32)
             for k in ("tokens", "targets")}
    prefill = build_step(cfg, _shape("prefill", seq=128), mesh)
    flash_attention.launches = 0
    logits, cache = prefill.fn(params, lora, {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.n_layers
    assert logits.shape == (BATCH, 1, cfg.vocab_size) and torch.isfinite(logits.float()).all()
    train = build_step(cfg, _shape("train", seq=128), mesh)
    loss, _, _ = train.fn(params, lora, AdamW(1e-5).init(lora), batch)
    assert torch.isfinite(loss)
