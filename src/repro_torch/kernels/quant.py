"""ctypes binding of the per-row int8 quantization CUDA kernel
(``csrc/quant.cu``), with its launch counter.

    scale = max(absmax(x_row) / 127, 1e-12)
    q     = clip(round_half_to_even(x / scale), -127, 127)

x (N, d) float32 -> (q int8 (N, d), scale float32 (N,)), any N and d.  On
finite inputs the kernel's q and scale equal the plain version's bit for
bit, rounding ties included.

A CUDA tensor launches the kernel on the current stream or raises; a CPU
tensor takes the plain version (``ref.quantize_rows_ref``).  The counter
``quantize_rows.launches`` grows by one per kernel launch and by nothing
else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quantize_rows_ref

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        fn = build.load("quant").quantize_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes a 2-D x, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError("quantize_rows takes a float32 tensor")
    if not x.is_contiguous():
        raise ValueError("quantize_rows takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_rows runs on cuda or cpu, not {x.device}")
    if x.shape[1] == 0 or x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError("quantize_rows takes 1 to 2**31 - 1 columns and "
                         "fewer than 2**31 rows")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x)
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scale
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), n, d, stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA error {rc}")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0
