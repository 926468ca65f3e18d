#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the main path, compiled with nvcc from the
   sources in this checkout;
3. kernel check: each kernel against its plain PyTorch version on the card,
   forward and backward, at the main path's shape and at a ragged shape,
   with times for the kernel, the plain version and the base product;
4. main path: the paper's split-federated round at the full width of
   bert-base (12 layers, d 768, vocab 30522, seq 128, batch 16) across the
   six paper clients at the paper cuts, scheme "ours", analytic engine,
   2 rounds with one aggregation and one evaluation, through the fused
   kernel; the kernel's launch count must equal the count derived in
   PERF.md;
5. comparison: the same run on the reference's default einsum path; the
   per-round losses must agree;
6. summary: one JSON line per ported kernel, then the device line last.

``--profile`` adds a phase before the summary: one warm round of each path
under ``torch.profiler``, with the device time by kernel, the host time by
operator, and the device's busy share of the round's wall time.

Exits non-zero without a result when no CUDA device is available, or when
run from a directory that does not hold the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()   # TF32 off for matmuls and cuDNN: fp32 as in the reference

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import make_emotion_dataset  # noqa: E402
from repro_torch.fed import (PAPER_CLIENTS, PAPER_CUTS, AggConfig,  # noqa: E402
                             EngineConfig, FedRunConfig, Simulator)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lora_matmul import lora_matmul  # noqa: E402
from repro_torch.kernels.ops import fused_lora_matmul  # noqa: E402
from repro_torch.kernels.ref import lora_matmul_ref  # noqa: E402

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain version: fp32 sums taken in another order differ by a few
# ulps of the largest partial sum; 1e-4 of the output's scale is far above
# that and far below any indexing or masking fault (which is O(1))
KERNEL_RTOL = 1e-4
# fused run vs einsum run, per-round mean loss: the two paths differ only in
# fp32 summation order, but AdamW's first step moves each adapter element by
# about lr whatever the gradient's size, so an element whose gradient is near
# zero can move the other way (ROADMAP Queue C.1); that shifts the round-2
# loss by far less than 1e-3 of its value
LOSS_RTOL = 1e-3

ROUNDS, BATCH, SEQ, LR = 2, 16, 128, 1e-3
N_TRAIN, N_TEST = 4000, 512


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


def check_lora_matmul(m: int, k: int, n: int, r: int, seed: int) -> dict:
    """Kernel vs plain version, forward and backward, at one shape."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * std)
                                .astype(np.float32)).to(dev)

    x, w = t(m, k), t(k, n, std=1 / math.sqrt(k))
    a, b = t(r, k, std=1 / math.sqrt(r)), t(n, r, std=0.1)
    g = t(m, n)
    scale = 2.0
    y = lora_matmul(x, w, a, b, scale=scale)
    y_ref = lora_matmul_ref(x, w, a, b, scale)
    torch.cuda.synchronize()
    out = {"shape": [m, k, n, r], "fwd_err": norm_err(y, y_ref)}

    grads = {}
    for name, fn in (("kernel", fused_lora_matmul), ("plain", None)):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        if fn is None:
            yy = lora_matmul_ref(xs, w, as_, bs, scale)
        else:
            yy = fn(xs, w, as_, bs, scale=scale)
        grads[name] = torch.autograd.grad(yy, (xs, as_, bs), g)
    torch.cuda.synchronize()
    for label, got, want in zip(("dx", "da", "db"), grads["kernel"], grads["plain"]):
        out[f"{label}_err"] = norm_err(got, want)
    out["max_abs_err"] = float((y - y_ref).abs().max())
    bad = {key: v for key, v in out.items() if key.endswith("_err")
           and key != "max_abs_err" and not v <= KERNEL_RTOL}
    if bad:
        raise AssertionError(f"lora_matmul disagrees with its plain version at "
                             f"{out['shape']}: {bad} (tolerance {KERNEL_RTOL})")

    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * n * r
    nbytes = 4 * (m * k + k * n + r * k + n * r + m * n)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    out.update(
        ms=cuda_ms(lambda: lora_matmul(x, w, a, b, scale=scale)),
        plain_ms=cuda_ms(lambda: lora_matmul_ref(x, w, a, b, scale)),
        base_matmul_ms=cuda_ms(lambda: torch.matmul(x, w)),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        gflop=flops / 1e9, mbytes=nbytes / 1e6)
    return out


def expected_launches(cfg, cuts, n_eval_batches: int, rounds: int) -> list:
    """Kernel launches per round on the main path (derivation in PERF.md).

    Per client and round, with T adapted projections per layer and L layers:
    client forward T*cut, client backward T*cut - 3 (dx for every adapted
    projection except wq/wk/wv of layer 0, whose input is the frozen
    embedding), server forward T*(L - cut), server backward T*(L - cut) (dx
    everywhere, down to dv) — 2*T*L - 3 whatever the cut.  The evaluation
    after the last round runs T*L forward launches per test batch.
    """
    t, nl = len(cfg.lora.targets), cfg.n_layers
    per_round = sum(2 * t * nl - 3 for _ in cuts)
    counts = [per_round] * rounds
    counts[-1] += n_eval_batches * t * nl
    return counts


def run_main_path(fused: bool, train, test) -> dict:
    cfg = REGISTRY["bert-base"]
    run = FedRunConfig(scheme="ours", rounds=ROUNDS, batch_size=BATCH,
                       seq_len=SEQ, lr=LR, seed=0,
                       engine=EngineConfig(mode="analytic", fused_lora=fused),
                       agg=AggConfig(policy="sync", interval=2))
    t0 = time.perf_counter()
    sim = Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test, run,
                    device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = []
    mark = {"t": 0.0, "launches": 0}

    def on_round(rec):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({"round": rec.round, "loss": rec.mean_loss,
                     "sim_time_s": rec.sim_time_s, "accuracy": rec.accuracy,
                     "f1": rec.f1, "wall_s": now - mark["t"],
                     "launches": lora_matmul.launches - mark["launches"],
                     "max_mem_bytes": torch.cuda.max_memory_allocated()})
        mark["launches"] = lora_matmul.launches
        torch.cuda.reset_peak_memory_stats()
        mark["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    lora_matmul.launches = 0
    mark["t"] = time.perf_counter()
    sim.run_training(on_round=on_round)
    total = lora_matmul.launches
    label = "fused" if fused else "einsum"
    for row in rows:
        print(f"[main:{label}] round {row['round']} loss={row['loss']:.7f} "
              f"sim_time_s={row['sim_time_s']:.6f} accuracy={row['accuracy']} "
              f"wall_s={row['wall_s']:.3f} launches={row['launches']} "
              f"max_mem_bytes={row['max_mem_bytes']}", flush=True)
    for row in rows:
        if not math.isfinite(row["loss"]):
            raise AssertionError(f"non-finite loss in round {row['round']}")
    acc = rows[-1]["accuracy"]
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"evaluation gave accuracy {acc}")
    n_eval = min(32, len(test) // BATCH)
    return {"rows": rows, "launches": total, "setup_s": setup_s,
            "expected": expected_launches(sim.cfg, sim.cuts, n_eval, ROUNDS),
            "data_sizes": sim.data_sizes}


def profile_round(fused: bool, train, test) -> dict:
    """One warm round (the second, with its aggregation) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = REGISTRY["bert-base"]
    run = FedRunConfig(rounds=ROUNDS, batch_size=BATCH, seq_len=SEQ, lr=LR,
                       engine=EngineConfig(fused_lora=fused),
                       agg=AggConfig(interval=2))
    sim = Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test, run, device="cuda")
    sim.run_round(0)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = "fused" if fused else "einsum"
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share": e.self_device_time_total / device_us} for e in events[:12]]
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    host_top = [{"op": e.key[:60], "calls": e.count,
                 "host_ms": e.self_cpu_time_total / 1e3} for e in host]
    out = {"path": label, "wall_s": wall, "device_s": device_us / 1e6,
           "busy_share": device_us / 1e6 / wall, "top": top, "host_top": host_top}
    print(f"[profile:{label}] wall_s={wall:.4f} device_s={device_us / 1e6:.4f} "
          f"busy_share={out['busy_share']:.3f}", flush=True)
    for row in top:
        print(f"[profile:{label}] device {row['share']:6.3f} {row['device_ms']:9.3f} ms "
              f"{row['calls']:6d} x {row['kernel']}", flush=True)
    for row in host_top:
        print(f"[profile:{label}] host {row['host_ms']:9.3f} ms {row['calls']:6d} x "
              f"{row['op']}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm round of each path")
    args = ap.parse_args()
    card = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    build.load("lora_matmul")
    seconds, log = build.BUILD_LOG.get("lora_matmul", (0.0, ""))
    print(f"[build] lora_matmul ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {seconds:.2f} s)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}", flush=True)

    checks = [check_lora_matmul(2048, 768, 768, 16, seed=0),
              check_lora_matmul(37, 100, 130, 5, seed=1)]
    for c in checks:
        print(f"[kernel] lora_matmul {json.dumps(c)}", flush=True)

    train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=30_522, seed=0)
    test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=30_522, seed=1)
    fused = run_main_path(True, train, test)
    print(f"[main:fused] setup_s={fused['setup_s']:.3f} data_sizes="
          f"{fused['data_sizes']} launches={fused['launches']} "
          f"expected={fused['expected']}", flush=True)
    got = [row["launches"] for row in fused["rows"]]
    if got != fused["expected"] or fused["launches"] == 0:
        raise AssertionError(f"lora_matmul launches per round {got}, "
                             f"expected {fused['expected']}")

    plain = run_main_path(False, train, test)
    if plain["launches"] != 0:
        raise AssertionError("the einsum path launched the fused kernel")
    for rf, rp in zip(fused["rows"], plain["rows"]):
        diff = abs(rf["loss"] - rp["loss"])
        print(f"[compare] round {rf['round']} fused={rf['loss']:.7f} "
              f"einsum={rp['loss']:.7f} |diff|={diff:.3e} "
              f"sim_time_equal={rf['sim_time_s'] == rp['sim_time_s']}", flush=True)
        if not diff <= LOSS_RTOL * abs(rp["loss"]):
            raise AssertionError(f"fused and einsum losses disagree in round "
                                 f"{rf['round']}: {diff} (rtol {LOSS_RTOL})")
        if rf["sim_time_s"] != rp["sim_time_s"]:
            raise AssertionError("simulated times differ between the paths")

    if args.profile:
        for fused_path in (True, False):
            profile_round(fused_path, train, test)

    main_shape, ragged = checks
    kernels = [{
        "name": "lora_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:62",
        "launches": fused["launches"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "base_matmul_ms": main_shape["base_matmul_ms"],
        "ragged_max_abs_err": ragged["max_abs_err"],
        "ok": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
