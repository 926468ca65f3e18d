"""Dry-run of the launch layer on one H100: a FLOP and memory report of every
(architecture x input shape) step.  Port of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each step for a TPU pod on placeholder
host devices and reads memory, cost and roofline terms from XLA.  The
port's mesh is one card, so a step's global batch runs on it whole.  By
default nothing is allocated: the step is traced on ``meta`` stand-ins
(``cost_analysis``), and the record gives the arguments' and outputs'
bytes, whether the arguments fit the card, the FLOPs and bytes, and the
roofline terms at the card's peaks.  ``--execute`` also runs the step on
the card at ``--batch`` (default: the shape's), from random weights and a
random batch made from ``--seed``: once warm and once timed, with the
peak device memory and each kernel's launches.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape prefill_32k \\
        --attn-impl chunked --execute --batch 1
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, ASSIGNED_SHAPES, get_config, get_shape
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_lora import grouped_lora_chunk, grouped_lora_direct
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.quant import quantize_rows
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import ShardingPolicy
from repro_torch.launch.steps import build_server_resume_step, build_step, resolve_cfg
from repro_torch.models import build_model
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

# NVIDIA H100 SXM 80GB HBM3 at 700 W, the data sheet's dense peaks: bf16 on
# the tensor cores; float32 on the CUDA cores (the port keeps TF32 off,
# numerics.set_fp32_policy, so its 495e12 is not reached); HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
CARD_BYTES = 80e9           # an H100 80GB's memory, where no card is present
MESH_NAME = "1x1"           # the one-card mesh {"data": 1, "model": 1}

# Per-arch baseline sharding of the reference (grok-1's weights need FSDP
# on its pod); the policy's specs change nothing on one card
ARCH_BASE_POLICY = {
    "grok-1-314b": {"fsdp": True},
}

# each kernel's launch counter, read around an executed step
COUNTERS = {"lora_matmul": lora_matmul, "grouped_lora_chunk": grouped_lora_chunk,
            "grouped_lora_direct": grouped_lora_direct, "quantize_rows": quantize_rows,
            "flash_attention": flash_attention, "wkv6": wkv6}


def should_skip(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family == "encdec":
        return "enc-dec over 30s audio windows has no 500k-token decode (DESIGN.md §6)"
    if shape_name in ("decode_32k", "long_500k") and cfg.family == "encoder":
        return "encoder-only model has no decode step"
    return None


def model_flops_global(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (train), 2*N*D (prefill), 2*N*B (decode);
    N = active params (MoE: routed top-k only)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def card_bytes(device) -> float:
    """The card's memory, or an H100 80GB's where the mesh is not on a card."""
    dev = torch.device(device)
    return (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
            else CARD_BYTES)


def _memory(args, out) -> dict:
    """The stand-ins' bytes; outputs that are argument tensors (a decode
    step's cache, written in place) count as aliased."""
    arg_ids = {id(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = sum(t.numel() * t.element_size() for t in outs if id(t) in arg_ids)
    return {"argument_bytes": _bytes(args), "output_bytes": _bytes(tuple(outs)),
            "temp_bytes": None, "alias_bytes": alias, "peak_bytes": None}


def _roofline(ops: cost_analysis.OpCosts, dtype: str, mflops) -> dict:
    terms = {"compute_s": ops.flops / PEAK_FLOPS[dtype],
             "memory_s": ops.bytes_accessed / HBM_BW, "collective_s": 0.0}
    bound = max(terms.values())
    return {**terms, "dominant": max(terms, key=terms.get),
            "model_flops_per_device": mflops,
            "useful_flops_ratio": (mflops / ops.flops) if mflops and ops.flops else None,
            "step_time_lower_bound_s": bound,
            "mfu_bound": mflops / PEAK_FLOPS[dtype] / bound if mflops and bound > 0 else None}


def _ops(ops: cost_analysis.OpCosts) -> dict:
    return {"flops_per_device": ops.flops, "bytes_per_device": ops.bytes_accessed,
            "collective_bytes_per_device": ops.collective_bytes,
            "collective_breakdown": ops.collective_breakdown,
            "n_collectives": ops.n_collectives}


def _real_args(bundle, seed: int):
    """The step's arguments on the mesh's card: the model's params and
    adapters from ``init_params``/``init_lora``, AdamW's zero state, and a
    random batch (tokens below the vocabulary, normal frames and
    embeddings), all from ``seed`` by an explicit generator; a decode
    step's cache is the model's zero cache."""
    dev = bundle.mesh.device
    cfg = bundle.cfg
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev)
    params = model.init_params(gen.manual_seed(seed))
    lora = model.init_lora(gen.manual_seed(seed + 1))
    gen.manual_seed(seed + 2)

    def fill(t):
        if not t.is_floating_point():
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device=dev,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

    spec = bundle.args
    if bundle.name == "serve_step":      # the stand-in position is the cache's last slot
        cache = model.init_cache(spec[3].shape[0], spec[4] + 1)
        return (params, lora, cache, fill(spec[3]), spec[4])
    if bundle.name == "prefill_step":
        return (params, lora, tree_map(fill, spec[2]))
    opt = AdamW(1e-5).init(lora)
    if bundle.name == "server_resume_step":
        return (params, lora, opt, fill(spec[3]), tree_map(fill, spec[4]), None)
    return (params, lora, opt, tree_map(fill, spec[3]))


def _execute(bundle, args) -> dict:
    """One warm call (the kernels' build and first launches), then one
    timed call with the arguments resident: host seconds ending in
    ``torch.cuda.synchronize()``, the peak device memory over it, and each
    kernel's launches in it."""
    dev = bundle.mesh.device
    t0 = time.perf_counter()
    out = bundle.fn(*args)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    del out
    arg_bytes = torch.cuda.memory_allocated(dev)
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = bundle.fn(*args)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    return {"out": out, "warm_s": warm_s, "step_s": step_s, "peak_bytes": peak,
            "temp_bytes": peak - arg_bytes,
            "launches": {name: fn.launches for name, fn in COUNTERS.items()}}


def _fits(mem: dict, device) -> dict:
    cap = card_bytes(device)
    return {"card_bytes": cap, "fits": mem["argument_bytes"] <= cap}


def run_one(arch: str, shape_name: str, *, policy: ShardingPolicy, out_dir: str,
            lr: float = 1e-5, tag: str = "",
            cfg_overrides: dict | None = None, device: str = "cuda", execute: bool = False,
            batch: int | None = None, seed: int = 0) -> dict:
    shape = get_shape(shape_name)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    skip = should_skip(arch, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAME,
        "policy": dataclasses.asdict(policy), "tag": tag,
        "cfg_overrides": cfg_overrides or {},
    }
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    base_cfg = get_config(arch)
    if cfg_overrides:
        base_cfg = base_cfg.with_(**cfg_overrides)
    cfg = resolve_cfg(base_cfg, shape)
    mesh = make_production_mesh(device=device)

    t0 = time.time()
    bundle = build_step(base_cfg, shape, mesh, policy, lr=lr)
    out, ops = cost_analysis.trace(bundle.fn, *bundle.args)
    t_lower = time.time() - t0
    mem = _memory(bundle.args, out)
    mem.update(_fits(mem, mesh.device))
    mflops = model_flops_global(cfg, shape) / mesh.size
    if batch is not None:
        rec["batch"] = batch
    rec.update({
        "status": "ok",
        "n_chips": mesh.size,
        "t_lower_s": round(t_lower, 2),
        "t_compile_s": None,
        "memory": mem,
        "cost_analysis_raw": {"flops": ops.plain_flops, "bytes accessed": ops.plain_bytes},
        "ops": _ops(ops),
        "roofline": _roofline(ops, cfg.dtype, mflops),
    })
    if execute:
        # decided before the run: the arguments must fit the card
        if not mem["fits"]:
            rec["execute"] = (f"not run: {mem['argument_bytes']} argument bytes "
                              f"exceed the card's {mem['card_bytes']}")
        else:
            res = _execute(bundle, _real_args(bundle, seed))
            rec["t_compile_s"] = round(res["warm_s"], 2)
            rec["memory"].update(peak_bytes=res["peak_bytes"], temp_bytes=res["temp_bytes"])
            rec["step_s"] = res["step_s"]
            rec["launches"] = res["launches"]
            rec["device"] = torch.cuda.get_device_name(mesh.device)
    _write(rec, out_dir, f"{arch}_{shape_name}_{MESH_NAME}", tag)
    return rec


def run_server_resume(arch: str, *, batch: int, seq_len: int, policy: ShardingPolicy,
                      out_dir: str, tag: str = "",
                      device: str = "cuda", execute: bool = False, cuts=(),
                      seed: int = 0) -> dict:
    """The paper's Alg. 1 server step (Eq. 4): resume at a cut that is an
    argument, from uploaded client activations; ONE step serves every
    client and cut.  Traced on ``meta``; with ``execute``, run on the card
    at each of ``cuts`` in turn, once warm and once timed, each timed
    call's loss and ``dv`` shape recorded."""
    cfg = get_config(arch)
    mesh = make_production_mesh(device=device)
    t0 = time.time()
    bundle = build_server_resume_step(cfg, mesh, policy, batch=batch, seq_len=seq_len)
    out, ops = cost_analysis.trace(bundle.fn, *bundle.args)
    t_lower = time.time() - t0
    mem = _memory(bundle.args, out)
    mem.update(_fits(mem, mesh.device))
    rec = {
        "arch": arch, "shape": f"server_resume_b{batch}_s{seq_len}",
        "mesh": MESH_NAME, "status": "ok", "tag": tag,
        "policy": dataclasses.asdict(policy),
        "t_lower_s": round(t_lower, 2), "t_compile_s": None,
        "memory": mem,
        "ops": _ops(ops),
        "roofline": _roofline(ops, cfg.dtype, None),
    }
    if execute and not rec["memory"]["fits"]:
        rec["execute"] = "not run: the arguments do not fit the card"
    elif execute:
        args = _real_args(bundle, seed)
        runs = {}
        for cut in cuts:
            cut_t = torch.tensor(cut, dtype=torch.int32, device=mesh.device)
            res = _execute(bundle, args[:-1] + (cut_t,))
            loss, _, _, dv = res["out"]
            runs[str(cut)] = {"loss": float(loss), "dv_shape": list(dv.shape),
                              "dv_finite": bool(torch.isfinite(dv).all()),
                              "warm_s": res["warm_s"], "step_s": res["step_s"],
                              "peak_bytes": res["peak_bytes"],
                              "temp_bytes": res["temp_bytes"], "launches": res["launches"]}
            rec["t_compile_s"] = rec["t_compile_s"] or round(res["warm_s"], 2)
        rec["cuts"] = runs
        rec["device"] = torch.cuda.get_device_name(mesh.device)
    _write(rec, out_dir, f"{arch}_server-resume_{MESH_NAME}", tag)
    return rec


def _write(rec: dict, out_dir: str, stem: str, tag: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        with open(os.path.join(out_dir, f"{stem}{suffix}.json"), "w") as f:
            json.dump(rec, f, indent=1)


def _gib(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f}GiB"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's two-pod mesh: out of the port's scope")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's one- and two-pod meshes: out of the port's scope")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--moe-shard-map", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--attn-impl", default=None, choices=("naive", "chunked"))
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--wkv-impl", default=None, choices=("scan", "chunked"))
    ap.add_argument("--wkv-chunk", type=int, default=None)
    ap.add_argument("--moe-token-chunks", type=int, default=None)
    ap.add_argument("--server-resume", action="store_true",
                    help="the Alg.1 server step (the cut an argument) instead")
    ap.add_argument("--cuts", type=int, nargs="+", default=[10, 30],
                    help="--server-resume --execute: the cuts the one step runs at")
    ap.add_argument("--batch", type=int, default=None,
                    help="the batch (default: the shape's global batch; 256 under "
                         "--server-resume)")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--execute", action="store_true",
                    help="also run the step on the card: warm, then timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--tag", default="", help="suffix for output files")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        ap.error("the port runs on one card, the mesh {'data': 1, 'model': 1}: "
                 "--multi-pod and --both-meshes are out of its scope")
    set_fp32_policy()
    if args.execute and torch.device(args.device).type != "cuda":
        raise SystemExit("--execute runs the step on the card: drop --device cpu")

    if args.server_resume:
        policy = ShardingPolicy(fsdp=args.fsdp, seq_shard=args.seq_shard)
        batch = args.batch if args.batch is not None else 256
        for arch in ([args.arch] if args.arch else ["granite-3-2b"]):
            rec = run_server_resume(arch, batch=batch, seq_len=args.seq, policy=policy,
                                    out_dir=args.out, tag=args.tag, device=args.device,
                                    execute=args.execute, cuts=args.cuts, seed=args.seed)
            r = rec["roofline"]
            print(f"[ok] {arch} server_resume b{batch} s{args.seq}: "
                  f"trace={rec['t_lower_s']:.0f}s "
                  f"args={_gib(rec['memory']['argument_bytes'])} "
                  f"compute={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
                  f"coll={r['collective_s']*1e3:.2f}ms", flush=True)
            for cut, run in rec.get("cuts", {}).items():
                print(f"[run] {arch} server_resume cut {cut}: loss={run['loss']:.4f} "
                      f"dv={run['dv_shape']} step={run['step_s']*1e3:.1f}ms "
                      f"peak={_gib(run['peak_bytes'])}", flush=True)
            print(json.dumps(rec), flush=True)
        return

    overrides = {}
    for key in ("attn_impl", "attn_chunk", "wkv_impl", "wkv_chunk", "moe_token_chunks"):
        val = getattr(args, key)
        if val is not None:
            overrides[key] = val

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(ASSIGNED_SHAPES)

    failures = 0
    for arch in archs:
        base = dict(fsdp=args.fsdp, seq_shard=args.seq_shard,
                    moe_shard_map=args.moe_shard_map, microbatch=args.microbatch)
        base.update(ARCH_BASE_POLICY.get(arch, {}))
        policy = ShardingPolicy(**base)
        for shape in shapes:
            label = f"{arch} x {shape} x {MESH_NAME}"
            try:
                rec = run_one(arch, shape, policy=policy, out_dir=args.out,
                              tag=args.tag, cfg_overrides=overrides,
                              device=args.device, execute=args.execute,
                              batch=args.batch, seed=args.seed)
            except Exception:
                failures += 1
                print(f"[FAIL] {label}")
                traceback.print_exc()
                continue
            if rec["status"] == "skipped":
                print(f"[skip] {label}: {rec['reason']}")
                continue
            r, m = rec["roofline"], rec["memory"]
            print(f"[ok] {label}: trace={rec['t_lower_s']:.0f}s "
                  f"args={_gib(m['argument_bytes'])} fits={m['fits']} "
                  f"peak={_gib(m['peak_bytes'])} "
                  f"compute={r['compute_s']*1e3:.2f}ms "
                  f"mem={r['memory_s']*1e3:.2f}ms "
                  f"coll={r['collective_s']*1e3:.2f}ms "
                  f"dom={r['dominant']} "
                  f"useful={r['useful_flops_ratio'] and round(r['useful_flops_ratio'], 3)}",
                  flush=True)
            if args.execute:
                print(json.dumps(rec), flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
