"""Readings for the limits of a cell's comparison, on the chip at the
cell's own size (not part of a benchmark run).

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

For each seed: the program's set-up steps against the reference (the
lower readings), and on the first ``--control-seeds`` seeds the control
(the reference one precision below the configuration's: fp8 for bf16,
TF32 for fp32 with TF32 off) and each fault planted in the reference put
in the program's place (half of the batch left out; one answer altered),
each against the reference.  A state left unchanged reads 1 on
``change_gap`` by definition.  One JSON line per reading goes to
standard output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
FAULTS = ("half_batch", "altered_answer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from harness import cells, compare
    from repro_torch.numerics import set_fp32_policy
    set_fp32_policy()
    cell = cells.load_cell(args.workload)
    kind = cells.kind(cell.traffic["kind"])
    control = CONTROL[cell.mc["dtype"]]

    def emit(what, seed, vals, t0):
        print(json.dumps({"cell": args.workload, "kind": what, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 2), **vals}), flush=True)

    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        t0 = time.perf_counter()
        program = kind.Program(cell.mc, cell.traffic, seed, args.device)
        program.setup()
        readings = program.readings
        program.free()
        del program
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        ref = kind.reference(cell.mc, cell.traffic, seed, args.device)
        emit("program", seed, compare.numbers(readings, ref), t0)
        if j < args.control_seeds:
            t0 = time.perf_counter()
            emit(f"control_{control}", seed,
                 compare.numbers(kind.reference(cell.mc, cell.traffic, seed, args.device,
                                               control), ref), t0)
            for fault in FAULTS:
                t0 = time.perf_counter()
                emit(f"fault_{fault}", seed,
                     compare.numbers(kind.reference(cell.mc, cell.traffic, seed, args.device,
                                                   fault=fault), ref), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
