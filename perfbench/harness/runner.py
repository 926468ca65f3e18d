"""One run of one cell: set-up, the measured window (or, with tracing,
the traced slice), the memory peak, the program's state freed, the
reference, the comparison, and the result line."""
from __future__ import annotations

import gc
import math
import sys
import time
import types
from typing import Optional

import torch

from harness import cells, compare, stats
from harness import trace as trace_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (an entry set to None blocks an import; nothing loaded)."""
    loaded = {m.split(".")[0] for m, mod in list(sys.modules.items()) if mod is not None}
    return sorted(loaded & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def _profiled(prog, device, host_ops: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host_ops or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work = prog.trace_slice()
        _sync(device)
        window_s = time.perf_counter() - t0
    return work, trace_lib.summarize(prof, window_s)


def _traced(prog, device, log):
    """The per-layer metrics come from a slice traced with the device's
    activity alone (recording every host op too would stretch the host's
    share of the slice); a second slice with the host's ops says what the
    host was doing in the device's idle gaps."""
    work, summary = _profiled(prog, device, host_ops=False)
    _, with_host = _profiled(prog, device, host_ops=True)
    summary.idle_gaps = with_host.idle_gaps
    print(f"trace: slice with host ops window_s={with_host.window_s} "
          f"busy_s={with_host.busy_s}", file=log)
    return work, summary


def _per_layer(cell, work: dict, summary) -> dict:
    """Each of the cell's per-layer metrics its reader finds something for."""
    ctx = types.SimpleNamespace(mc=cell.mc, traffic=cell.traffic, work=work, trace=summary)
    metrics = {}
    for m in cell.per_layer:
        value = cells.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def _end_to_end(cell, res: dict, peak: int, setup_s: float, log) -> dict:
    values = {"tokens_per_s": res["tokens"] / res["elapsed_s"],
              "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    if "latencies_s" in res:
        lat = res["latencies_s"]
        values["upload_p95_ms"] = stats.percentile(lat, 95) * 1e3
        # the nearest rank the p95 takes, how many uploads lie beyond it, and
        # its neighbours: how finely a window of this many uploads reads it
        xs, rank = sorted(lat), math.ceil(0.95 * len(lat))
        print(f"window: uploads={len(lat)} elapsed_s={res['elapsed_s']} "
              f"p50_ms={stats.percentile(lat, 50) * 1e3} p95_rank={rank} "
              f"beyond_p95={len(lat) - rank} "
              f"near_p95_ms={[round(x * 1e3, 3) for x in xs[max(0, rank - 3):rank + 2]]}", file=log)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
            process_start: float, log=sys.stderr) -> dict:
    """The run's result line: correct, attempted, failed, metrics, device,
    with tracing the breakdown, and ``checks`` last."""
    device = torch.device(device)
    kind = cells.kind(cell.traffic["kind"])
    prog = kind.Program(cell.mc, cell.traffic, seed, device)
    t_setup = time.time()
    prog.setup()
    _sync(device)
    setup_s = time.time() - process_start
    print(f"setup: imports {t_setup - process_start:.2f} s, the program's set-up "
          f"{time.time() - t_setup:.2f} s ({prog.setup_log})", file=log)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    breakdown: Optional[dict] = None
    if trace:
        work, summary = _traced(prog, device, log)
        metrics = _per_layer(cell, work, summary)
        attempted, failed = work["attempted"], work["failed"]
        breakdown = summary.breakdown()
        print(f"trace: window_s={summary.window_s} busy_s={summary.busy_s} "
              f"kernels={summary.n_kernels} work={ {k: v for k, v in work.items() if k != 'calls'} }",
              file=log)
    else:
        res = prog.window(seconds)
        attempted, failed = res["attempted"], res["failed"]
    _sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    if not trace:
        metrics = _end_to_end(cell, res, peak, setup_s, log)
    readings = prog.readings
    prog.free()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = kind.reference(cell.mc, cell.traffic, seed, device)
    checks = compare.check(compare.numbers(readings, ref), cell.limits)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=log)
    dev = _device_info(device, peak)
    if trace:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": compare.all_ok(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return result
