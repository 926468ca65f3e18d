"""Activation transport compression for the client<->server wireless links.
Port of ``src/repro/comm/quantization.py``.

Per-token symmetric int8 quantization with error feedback: about 4x fewer
bytes on both links.  Activations (B, S, d) are quantized per (B, S) row
with an absmax scale; the int8 payload and the f32 scales are what crosses
the "network".  The quantization itself is the hand-written kernel
``kernels/quant.py: quantize_rows`` (one launch over the flattened
(rows, d) for a CUDA tensor; its plain version for a CPU tensor).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.quant import quantize_rows


class Quantized(NamedTuple):
    q: torch.Tensor        # int8 payload, same shape as the input
    scale: torch.Tensor    # f32, input shape minus the quantized axis

    @property
    def nbytes(self) -> int:
        return self.q.numel() * 1 + self.scale.numel() * 4


def quantize(x: torch.Tensor, *, axis: int = -1) -> Quantized:
    """Symmetric per-row int8: q = round(x / s), s = absmax/127, ties to
    even.  float32 and bfloat16 go to the kernel as they are stored (it
    widens in registers); other types are cast to float32 first."""
    xm = x.movedim(axis, -1)
    if xm.dtype not in (torch.float32, torch.bfloat16):
        xm = xm.float()
    lead, d = xm.shape[:-1], xm.shape[-1]
    q, scale = quantize_rows(xm.reshape(-1, d).contiguous())
    return Quantized(q=q.reshape(*lead, d).movedim(-1, axis),
                     scale=scale.reshape(lead))


def dequantize(qx: Quantized, dtype=torch.float32, *, axis: int = -1) -> torch.Tensor:
    scale = qx.scale.unsqueeze(axis)
    return (qx.q.float() * scale).to(dtype)


def quantize_with_feedback(x: torch.Tensor, residual: Optional[torch.Tensor], *,
                           axis: int = -1):
    """Error-feedback quantization: the previous round's quantization error
    is added back before quantizing (EF-SGD style), so the bias does not
    accumulate across rounds.

    Returns (Quantized, new_residual)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    qx = quantize(xf, axis=axis)
    new_residual = xf - dequantize(qx, torch.float32, axis=axis)
    return qx, new_residual


def transport_bytes(shape, quantized: bool, dtype_bytes: int = 4) -> float:
    """Wire bytes for an activation/gradient tensor of ``shape``."""
    n = math.prod(shape)
    if not quantized:
        return float(n * dtype_bytes)
    rows = math.prod(shape[:-1])
    return float(n * 1 + rows * 4)
