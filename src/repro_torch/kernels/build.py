"""Build the port's CUDA C++ kernels with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>.so`` at the root of the checkout.  A
library is rebuilt when its source, a local header it includes
(``csrc/*.cuh``) or the flags change (a SHA-256 stamp sits beside it), and
the compile writes to a temporary name first, so processes that build at
once never load a half-written file.
:func:`load_all` compiles several sources at once, one ``nvcc`` each.
Nothing here runs at import time: the CPU path never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()                  # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}   # one per source: builds of
_LIBS: Dict[str, ctypes.CDLL] = {}           # different sources overlap
#: name -> (seconds the compile took, nvcc's output incl. -Xptxas -v);
#: empty for a library that was already built
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


BUILD_DIR = CSRC.parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> List[Path]:
    """``src`` and every header it includes by ``#include "..."``, found
    beside it, recursively, each once."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes()))
    return seen


def _digest(src: Path) -> str:
    """The stamp of a library: its source, the local headers it includes
    and the flags, so a change to a shared header rebuilds every library
    that includes it."""
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _compile(src: Path, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[src.stem] = (seconds, proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, built first if missing or stale."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}.so"
        stamp = out.with_name(out.name + ".sha256")
        digest = _digest(src)
        if not (out.exists() and stamp.exists()
                and stamp.read_text() == digest):
            _compile(src, out)
            tmp = stamp.with_name(f".{stamp.name}.{os.getpid()}.tmp")
            tmp.write_text(digest)
            os.replace(tmp, stamp)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Load several sources, compiling the stale ones in parallel."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(load, names))
    return dict(zip(names, libs))
