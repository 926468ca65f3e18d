"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Set-up makes every input from the seed, drives the program through the
steps the comparison checks and warms every shape the cell uses; then the
window measures (``--trace 0``: the cell's end-to-end metrics) or the
profiler traces a slice (``--trace 1``: its per-layer metrics); then the
plain reference decides ``correct``.  The last line of standard output is
the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.  Every cache goes under
``perfbench/.cache`` in the checkout.
"""
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """Wall time at which this process started (from /proc where it can)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"

# bytecode and every kernel cache at fixed paths inside the checkout, set
# before torch is imported (the card's host writes no bytecode by default)
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
# one process, one intra-op thread: the program's host work is one thread
# of dispatch, and idle pool threads only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from harness import cells, runner

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.numerics import set_fp32_policy
    set_fp32_policy()
    result = runner.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                            PROCESS_START)
    found = runner.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
