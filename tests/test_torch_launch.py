"""The launch layer of the port against the JAX package's: the mesh helpers,
the sharding plan's spec trees, the dry-run's skips, analytic FLOPs and
record, the FLOP count of a traced step against the reference's HLO
count, and serving.  Port only: ``cost_analysis``'s exact counts, the
kernels' plain versions on ``meta`` (counted as the kernel's work, no
launch), and the entry points as subprocesses on the CPU.  On the card:
the one-card mesh, the dry-run's executed step and serving.

Tolerances: the traced train step's FLOPs within 10 % of the reference's
``hlo_analysis`` count (eager PyTorch and XLA do not run the same
operations: the port's masked loop skips no owned layer's work, XLA's
while loop forms some products otherwise); spec trees, skips and analytic
FLOPs equal; greedy tokens equal.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import (ASSIGNED_SHAPES, PORT_ARCHS, REGISTRY, SHAPES,  # noqa: E402
                                 get_config, get_shape, reduced)
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun, serve  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the configs the reference has: each test here holds the port against it
ARCHS = sorted(n for n in REGISTRY if n not in PORT_ARCHS)
MESHES = [(1, 1), (2, 4), (16, 16), (2, 16, 16)]
POLICIES = {"default": {}, "fsdp": {"fsdp": True},
            "no_vocab_shard": {"shard_vocab_embed": False}}


def _jax():
    return pytest.importorskip("jax")


def _abstract(shape):
    from jax.sharding import AbstractMesh, AxisType
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape)), names


def _ref_dryrun():
    """The reference's dryrun module, imported with this process's device
    count left alone: it sets XLA_FLAGS for 512 host devices at import,
    which must reach neither this process's JAX nor a later subprocess."""
    jax = _jax()
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


# ---------------------------------------------------------------- the mesh

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_helpers_match_reference(shape):
    _jax()
    from repro.launch import mesh as jm
    jmesh, names = _abstract(shape)
    tmesh = M.Mesh.abstract(shape, names)
    assert tmesh.shape == dict(jmesh.shape) and tmesh.size == jmesh.size
    assert M.dp_axes(tmesh) == jm.dp_axes(jmesh)
    assert M.dp_size(tmesh) == jm.dp_size(jmesh)
    assert M.model_axis_size(tmesh) == jm.model_axis_size(jmesh)


def test_production_mesh_is_one_card():
    mesh = M.make_production_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices == (torch.device("cpu"),)
    assert M.make_debug_mesh(device="cpu") == mesh
    assert S.Placement(mesh, (None,)).device == torch.device("cpu")
    with pytest.raises(ValueError, match="out of its scope"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="out of its scope"):
        M.make_debug_mesh(2, 4, device="cpu")
    with pytest.raises(ValueError, match="out of its scope"):
        M.Mesh.abstract((2, 4), ("data", "model")).device


def test_production_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_production_mesh()


# ---------------------------------------------------------------- sharding plan

def _ref_specs(jax, tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    out = {}
    S._map_with_path(lambda path, pl: out.setdefault("/".join(map(str, path)), pl.spec), tree)
    return out


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 4)], ids=["16x16", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, mesh_shape, policy):
    """param_shardings, lora_shardings and batch_shardings (a train batch of
    32, a decode batch of 8 with its cache) give the reference's
    ``NamedSharding.spec`` leaf for leaf, on its abstract mesh."""
    jax = _jax()
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.launch import sharding as js
    from repro.models import build_model as j_build
    from repro.models import input_specs as j_input_specs

    jmesh, names = _abstract(mesh_shape)
    tmesh = M.Mesh.abstract(mesh_shape, names)
    jcfg, tcfg = j_reduced(J_REGISTRY[arch]), reduced(REGISTRY[arch])
    jm, tm = j_build(jcfg), build_model(tcfg, "meta")
    jpol, tpol = js.ShardingPolicy(**POLICIES[policy]), S.ShardingPolicy(**POLICIES[policy])
    want = _ref_specs(jax, js.param_shardings(jcfg, jm.params_spec(), jmesh, jpol))
    assert _port_specs(S.param_shardings(tcfg, tm.params_spec(), tmesh, tpol)) == want
    assert (_port_specs(S.lora_shardings(tm.lora_spec(), tmesh, tpol))
            == _ref_specs(jax, js.lora_shardings(jm.lora_spec(), jmesh, jpol)))
    kinds = ["train_4k"] + (["decode_32k"] if tcfg.family != "encoder" else [])
    for name, b in zip(kinds, (32, 8)):
        shape = dataclasses.replace(get_shape(name), seq_len=64, global_batch=b)
        got = S.batch_shardings(input_specs(tcfg, shape, tm, cache_len=64), tmesh)
        ref = js.batch_shardings(j_input_specs(jcfg, shape, jm, cache_len=64), jmesh)
        assert _port_specs(got) == _ref_specs(jax, ref), name


# ---------------------------------------------------------------- cost analysis

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cost_analysis_counts_a_matmul_and_no_views():
    c = cost_analysis.analyze(lambda a, b: a @ b, _meta(4, 8), _meta(8, 16))
    assert c.flops == 2 * 4 * 8 * 16
    assert c.bytes_accessed == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    c = cost_analysis.analyze(
        lambda a: a.view(8, 4).t().transpose(0, 1).reshape(32)[3:9].unsqueeze(0).expand(5, 6),
        _meta(4, 8))
    assert (c.flops, c.bytes_accessed) == (0, 0)
    # the backward's products count too: x @ w forward, dW = x^T g backward
    def grad_w(x, w):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad((x @ w).sum(), w)[0]
    c = cost_analysis.analyze(grad_w, _meta(4, 8), _meta(8, 16))
    assert c.flops == 2 * (2 * 4 * 8 * 16)
    assert (c.collective_bytes, c.collective_breakdown, c.n_collectives) == (0.0, {}, 0)


def test_kernels_on_meta_count_their_work_and_launch_nothing():
    """The flash and WKV6 wrappers on meta tensors run their plain
    versions: no launch is counted, and a trace counts the kernel's own
    operations and bytes (flash: the causal pairs alone)."""
    flash_attention.launches = wkv6.launches = 0
    b, s, h, kh, d = 2, 96, 4, 2, 32
    q = _meta(b, s, h, d, dtype=torch.bfloat16)
    k = _meta(b, s, kh, d, dtype=torch.bfloat16)
    c = cost_analysis.analyze(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, k)
    assert c.flops == 4 * b * h * d * (s * (s + 1) // 2)
    assert c.bytes_accessed == 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
    assert c.plain_flops == 4 * b * h * d * s * s            # the plain square
    assert work.attention_pairs(s, s, True, 16) == sum(min(i + 1, 16) for i in range(s))
    r = _meta(2, 40, 3, 16)
    out, c = cost_analysis.trace(wkv6, r, r, r, r, _meta(3, 16))
    assert c.flops == 7 * 2 * 40 * 3 * 16 * 16 and out[0].is_meta and out[1].shape == (2, 3, 16, 16)
    assert flash_attention.launches == wkv6.launches == 0
    assert not work.LISTENERS


@pytest.mark.parametrize("remat", [True, False])
def test_traced_train_step_flops_near_reference_hlo(remat):
    """Reduced granite-3-2b (2 layers, d 256), train at 2 x 64: the meta
    trace's FLOPs within 10 % of the reference's ``hlo_analysis`` count of
    its compiled step on a 1 x 1 mesh; no collective in either."""
    jax = _jax()
    from jax.sharding import AxisType

    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.launch import hlo_analysis
    from repro.launch import steps as jsteps

    shape = dataclasses.replace(get_shape("train_4k"), seq_len=64, global_batch=2)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jb = jsteps.build_step(j_reduced(J_REGISTRY["granite-3-2b"]), shape, jmesh, remat=remat)
    want = hlo_analysis.analyze(jb.lower().compile().as_text())
    got = build_step(reduced(REGISTRY["granite-3-2b"]), shape,
                     M.make_production_mesh(device="cpu"), remat=remat).analyze()
    gap = got.flops / want.flops - 1
    print(f"remat={remat}: port {got.flops:.5g} FLOPs, reference HLO {want.flops:.5g}, "
          f"gap {gap:+.2%}")
    assert abs(gap) <= 0.10
    assert got.collective_bytes == want.collective_bytes == 0
    assert got.bytes_accessed > 0


# ---------------------------------------------------------------- the dry-run

@pytest.mark.parametrize("arch", ARCHS)
def test_skips_and_model_flops_match_reference(arch):
    ref = _ref_dryrun()
    from repro.configs import get_config as j_get_config
    from repro.configs import get_shape as j_get_shape
    for name in SHAPES:
        assert dryrun.should_skip(arch, name) == ref.should_skip(arch, name)
        assert (dryrun.model_flops_global(get_config(arch), get_shape(name))
                == ref.model_flops_global(j_get_config(arch), j_get_shape(name)))


def _ref_record_keys():
    """The keys the reference's ``run_one`` gives an "ok" record, read from
    its source (running it needs 512 devices): the top level and each
    nested dict's."""
    tree = ast.parse((SRC / "repro" / "launch" / "dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    named = {node.targets[0].id: node.value for node in ast.walk(fn)
             if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
             and isinstance(node.targets[0], ast.Name)}

    def keys(d):        # a dict literal's keys, a ``**name`` splat's included
        return {kk.value for kk in d.keys if kk is not None} | {
            kk for k, v in zip(d.keys, d.values)
            if k is None and isinstance(v, ast.Name) for kk in keys(named[v.id])}

    top, nested = set(), {}
    for node in ast.walk(fn):
        d = None
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "rec":
            d = node.value
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update"
              and getattr(node.func.value, "id", "") == "rec"):
            d = node.args[0]
        if isinstance(d, ast.Dict):
            for k, v in zip(d.keys, d.values):
                top.add(k.value)
                if isinstance(v, ast.Dict):
                    nested[k.value] = keys(v)
    return top, nested


@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_record_has_the_reference_keys(arch, monkeypatch):
    """``run_one`` on meta for the reduced config, every assigned shape at
    2 x 64: an "ok" record with the reference's keys (``ops`` for its
    ``hlo``), finite counts, or the reference's skip."""
    top, nested = _ref_record_keys()
    monkeypatch.setattr(dryrun, "get_config", lambda a: reduced(REGISTRY[a]))
    monkeypatch.setattr(dryrun, "get_shape", lambda n: dataclasses.replace(
        SHAPES[n], seq_len=64, global_batch=2))
    for name in ASSIGNED_SHAPES:
        rec = dryrun.run_one(arch, name, policy=S.ShardingPolicy(), out_dir="", device="cpu")
        if dryrun.should_skip(arch, name):
            assert rec["status"] == "skipped"
            continue
        assert set(rec) - {"ops"} == top - {"hlo"}, name
        assert set(rec["ops"]) == nested["hlo"] and set(rec["roofline"]) == nested["roofline"]
        assert set(rec["memory"]) >= nested["memory"] and rec["memory"]["fits"]
        assert rec["ops"]["flops_per_device"] > 0 and rec["memory"]["argument_bytes"] > 0
        assert rec["ops"]["collective_bytes_per_device"] == 0 and rec["mesh"] == "1x1"
        # a decode step's cache comes back written in place: aliased
        aliased = rec["memory"]["alias_bytes"]
        assert (0 < aliased < rec["memory"]["output_bytes"]) == (get_shape(name).kind == "decode")


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_cli_full_size_on_meta(tmp_path):
    """granite-3-2b's train_4k step at full size (40 layers, d 2048, 256 x
    4096 tokens) traced on meta, and the server-resume step, on the CPU."""
    proc = _run("repro_torch.launch.dryrun", "--arch", "granite-3-2b", "--shape", "train_4k",
                "--device", "cpu", "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert any(ln.startswith("[ok] granite-3-2b x train_4k x 1x1:")
               for ln in proc.stdout.splitlines()), proc.stdout
    rec = json.loads((tmp_path / "granite-3-2b_train_4k_1x1.json").read_text())
    assert rec["memory"]["fits"] and rec["memory"]["peak_bytes"] is None
    assert rec["roofline"]["useful_flops_ratio"] > 0.5
    proc = _run("repro_torch.launch.dryrun", "--server-resume", "--batch", "4", "--seq", "1024",
                "--device", "cpu", "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("[ok] granite-3-2b server_resume b4 s1024:"), proc.stdout
    proc = _run("repro_torch.launch.dryrun", "--arch", "gemma-2b", "--execute",
                "--device", "cpu")
    assert proc.returncode != 0 and "drop --device cpu" in proc.stderr



@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_dryrun_multi_pod_flags_are_an_error(flag, capsys):
    """The reference's two-pod meshes are refused before any run, with the
    one-card scope named."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", flag, "--device", "cpu"])
    assert exc.value.code == 2 and "out of its scope" in capsys.readouterr().err


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-3b"])
def test_greedy_generate_matches_reference(arch):
    """The reference's prompt replay and greedy decode (its serve_step and
    sample_tokens at temperature 0) against ``serve.generate`` from the
    same bridged weights: the same tokens."""
    jax = _jax()
    import jax.numpy as jnp

    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.launch import serve as jserve
    from repro.models import build_model as j_build

    jcfg, tcfg = j_reduced(J_REGISTRY[arch]), reduced(REGISTRY[arch])
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jm.init_params(rng))
    rs = np.random.default_rng(1)
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype),
                        jax.tree.map(np.asarray, jm.init_lora(jax.random.fold_in(rng, 1))))
    b, prompt, new = 3, 10, 12
    tokens = rs.integers(0, jcfg.vocab_size, (b, prompt)).astype(np.int32)
    jp, jl = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora)
    cache = jm.init_cache(b, prompt + new)
    step = jax.jit(lambda p, lo, c, t, pos: jm.serve_step(p, lo, c, t, pos))
    for i in range(prompt):
        logits, cache = step(jp, jl, cache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
    want = []
    tok = jserve.sample_tokens(logits, rng, 0.0)
    for i in range(new):
        want.append(np.asarray(tok)[:, 0])
        logits, cache = step(jp, jl, cache, tok, jnp.int32(prompt + i))
        tok = jserve.sample_tokens(logits, rng, 0.0)
    got = serve.generate(tm, to_torch(params, "cpu"), to_torch(lora, "cpu"),
                         {"tokens": torch.from_numpy(tokens)}, new, 0.0, torch.Generator())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def test_sample_tokens_draws_by_temperature():
    logits = torch.tensor([[[0.0, 5.0, 1.0]], [[3.0, 0.0, 0.0]]])
    assert serve.sample_tokens(logits, torch.Generator(), 0.0).tolist() == [[1], [0]]
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([serve.sample_tokens(logits, gen, 100.0) for _ in range(200)])
    assert draws.dtype == torch.int32 and set(draws.flatten().tolist()) == {0, 1, 2}
    again = torch.Generator().manual_seed(0)
    assert torch.equal(draws, torch.cat([serve.sample_tokens(logits, again, 100.0)
                                         for _ in range(200)]))


def test_serve_cli_on_cpu():
    proc = _run("repro_torch.launch.serve", "--device", "cpu", "--new-tokens", "8")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[gemma-2b] generated (4, 8) tokens in ")
    assert lines[1].startswith("first sequence: ") and len(json.loads(lines[1][16:])) == 8


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_dryrun_executes_with_flash(cuda_device, monkeypatch):
    """On the card: the production mesh is cuda:0; the dry-run executes a
    reduced bf16 gemma-2b prefill (attn_impl "chunked"): one flash launch
    a layer in the timed call, a peak above the arguments; serving runs."""
    assert M.make_production_mesh().device == torch.device("cuda", 0)
    monkeypatch.setattr(dryrun, "get_config", lambda a: reduced(REGISTRY[a]).with_(
        dtype="bfloat16"))
    rec = dryrun.run_one("gemma-2b", "prefill_32k", policy=S.ShardingPolicy(), out_dir="",
                         cfg_overrides={"attn_impl": "chunked"}, execute=True, batch=1)
    assert rec["launches"]["flash_attention"] == reduced(REGISTRY["gemma-2b"]).n_layers
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["step_s"] > 0
    cfg = reduced(REGISTRY["gemma-2b"])
    model = build_model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params, lora = model.init_params(gen), model.init_lora(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, device=cuda_device)
    out = serve.generate(model, params, lora, {"tokens": toks}, 4, 0.8, gen)
    assert out.shape == (2, 4) and out.device.type == "cuda"
