"""ctypes binding of the per-row int8 quantization CUDA kernel
(``csrc/quant.cu``), with its launch counter.

    scale = max(absmax(x_row) / 127, 1e-12)
    q     = clip(round_half_to_even(x / scale), -127, 127)

x (N, d) float32 or bfloat16 -> (q int8 (N, d), scale float32 (N,)), any N
and d.  x is read in its stored type and widened to f32 inside the kernel,
as the reference's kernel casts inside.  On finite inputs the kernel's q and
scale equal the plain version's bit for bit, rounding ties included.

Two bodies, chosen before the launch by :func:`resident_loads`: a warp per
row holding the row in registers (rows of whole, aligned 16-byte chunks, up
to ``32 * MAX_LOADS`` of them), and a block per row that reads it twice
(every other row).

A CUDA tensor launches the kernel on the current stream or raises; a CPU
or ``meta`` tensor takes the plain version (``ref.quantize_rows_ref``),
which a trace on ``meta`` counts as the kernel's work (``work.py``).  The counter
``quantize_rows.launches`` grows by one per kernel launch, of either body
and either type, and by nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ref import quantize_rows_ref

MAX_LOADS = 16      # 16-byte loads a lane of the resident body holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the entry's type codes

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        lib = build.load("quant")
        fn = lib.quantize_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.quantize_rows_max_loads.argtypes = []
        lib.quantize_rows_max_loads.restype = ctypes.c_int
        if lib.quantize_rows_max_loads() != MAX_LOADS:
            raise RuntimeError("quant library and binding disagree on the resident "
                               "body's loads")
        _launch = fn
    return _launch


def resident_loads(x: torch.Tensor) -> int:
    """The 16-byte loads a lane of the resident body holds for ``x``'s rows,
    ``ceil(chunks / 32)``; 0 where the strided body takes them: a row that
    is not a whole number of 16-byte chunks, a base off a 16-byte boundary,
    or more than ``32 * MAX_LOADS`` chunks (d > 2048 in f32, 4096 in
    bf16).  A pure function of the shape, type and pointer."""
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        return 0
    loads = -(-(row_bytes // 16) // 32)
    return loads if loads <= MAX_LOADS else 0


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes a 2-D x, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"quantize_rows takes a float32 or bfloat16 tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_rows takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"quantize_rows runs on cuda, cpu or meta, not {x.device}")
    if x.shape[1] == 0 or x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError("quantize_rows takes 1 to 2**31 - 1 columns and "
                         "fewer than 2**31 rows")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x)
    if x.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.quantize_rows(x)):
            return quantize_rows_ref(x)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scale
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), n, d, DTYPES[x.dtype],
                resident_loads(x), stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA error {rc}")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0
