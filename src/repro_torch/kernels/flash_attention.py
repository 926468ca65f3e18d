"""ctypes binding of the online-softmax attention CUDA kernel
(``csrc/flash_attention.cu``), with its launch counter.

    out = softmax(q . k^T / sqrt(D) + mask) . v
    q (B,S,H,D), k/v (B,T,K,D) with K | H  ->  (B,S,H,D) in q.dtype

Query i and key j sit at positions i and j; the masks are causal
(i >= j), window (i - j < window) and none.  GQA/MQA: query head h reads
key/value head h // (H // K), with no repeated copy.  Float32 or
bfloat16, D in {32, 64, 112, 128, 256}; any strides with the last dimension
contiguous (bfloat16: 16-byte aligned, strides a multiple of 8, as TMA
reads them).

A CUDA tensor launches the kernel on the current stream or raises; a CPU
or ``meta`` tensor takes the plain version (``ref.flash_attention_ref`` on
the heads laid out as (B*H, S, D)), which a trace on ``meta`` counts as
the kernel's work (``work.py``: the kept pairs alone).  The counter ``flash_attention.launches`` grows
by one per kernel launch and by nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,S,H,D) and k, v (B,T,K,D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not share {k.shape[2]} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v of one type")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention inputs must share one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")


def _tma_ok(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def flash_attention_plain(q, k, v, causal, window):
    """The plain version in model layout: what a CPU tensor runs."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh

    def heads(x, n):   # (B,N,heads,D) -> (B*H,N,D), kv heads repeated
        if x.shape[2] != h:
            x = x.repeat_interleave(g, dim=2)
        return x.movedim(2, 1).reshape(b * h, n, d)

    out = flash_attention_ref(heads(q, s), heads(k, t), heads(v, t),
                              causal=causal, window=window)
    return out.reshape(b, h, s, d).movedim(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int] = None) -> torch.Tensor:
    _check(q, k, v, window)
    if q.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.flash_attention(q, k, v, causal, window)):
            return flash_attention_plain(q, k, v, causal, window)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {d}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the head dimension contiguous")
    if b * h > 65535:
        raise ValueError(f"flash_attention takes B*H <= 65535, got {b * h}")
    if q.dtype == torch.bfloat16 and not all(_tma_ok(x) for x in (q, k, v)):
        raise ValueError("bfloat16 flash_attention loads by TMA: q, k, v need "
                         "16-byte aligned data and strides a multiple of 8")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, s, t, h, kh, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(bool(causal)), 0 if window is None else int(window),
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
