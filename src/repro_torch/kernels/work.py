"""The work of a hand-written kernel's call, for a trace on ``meta`` tensors.

On ``meta`` tensors (shapes and types, no data) a kernel wrapper runs its
plain version to give its outputs' shapes; on the card it launches the
kernel, whose work is not the plain version's: flash attention skips the
key tiles its mask drops and keeps its probabilities on chip, WKV6 keeps
its state in registers.  Each wrapper runs its plain version inside
:func:`counted`: a trace that listens (``launch.cost_analysis``) then
counts the kernel's operations and the bytes it must move (each input read
once, each output written once) in place of the plain version's ops.
Where no trace listens, :func:`counted` does nothing.  Nothing here
launches a kernel or moves a launch counter.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# the traces that listen, innermost last: each has ``enter_kernel(flops,
# nbytes)`` and ``exit_kernel()``
LISTENERS: list = []


@contextlib.contextmanager
def counted(flops: float, nbytes: float):
    """Bracket a wrapper's plain version: the innermost listening trace
    counts (flops, nbytes) for the call and none of the ops inside."""
    sink = LISTENERS[-1] if LISTENERS else None
    if sink is None:
        yield
        return
    sink.enter_kernel(flops, nbytes)
    try:
        yield
    finally:
        sink.exit_kernel()


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lora_matmul(x, w, a, b) -> tuple:
    """y = x @ w + s * (x @ a^T) @ b^T: the base product and the two thin
    ones; x, w, a, b read once, y written once in x's type."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[-2]
    return 2.0 * m * k * n + 2.0 * m * r * (k + n), _nbytes(x, w, a, b) + m * n * x.element_size()


def quantize_rows(x) -> tuple:
    """No product: x read once, the int8 codes and f32 scales written once."""
    n, d = x.shape
    return 0.0, _nbytes(x) + n * d + 4 * n


def attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, queries at 0..s-1 and keys at
    0..t-1: the kernel's causal and window block skips leave only these
    (up to a tile's edge)."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(t, i + 1) if causal else np.full(s, t, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(q, k, v, causal: bool, window) -> tuple:
    """Q K^T and P V over the kept pairs, every query head (GQA reads the
    shared kv head, no copy); q, k, v read once, the output written once."""
    b, s, h, d = q.shape
    pairs = attention_pairs(s, k.shape[1], causal, window)
    return 4.0 * b * h * d * pairs, 2 * _nbytes(q) + _nbytes(k, v)


def flash_attention_bwd(q, k, v, causal: bool, window) -> tuple:
    """The backward's nine products over the kept pairs, every query head:
    S and dP in each of its two kernels, dV, and dQ and dK as two (the hi
    and lo terms of dS); q, k, v, o, dO and lse read once, dq, dk, dv and
    Delta written once."""
    b, s, h, d = q.shape
    pairs = attention_pairs(s, k.shape[1], causal, window)
    return (18.0 * b * h * d * pairs,
            4 * _nbytes(q) + 2 * _nbytes(k, v) + 2 * 4 * b * h * s)


def wkv6(r, k, v, w, u) -> tuple:
    """Per step and head, the D x D state's outer product, decay, bonus and
    read-out (7 operations an element, as the kernel's bound counts them);
    r, k, v, w, u read once, the output and the final f32 state written
    once."""
    b, t, h, d = r.shape
    return 7.0 * b * t * h * d * d, _nbytes(r, k, v, w, u, r) + 4 * b * h * d * d
