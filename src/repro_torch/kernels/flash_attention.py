"""ctypes binding of the flash-attention CUDA kernels
(``csrc/flash_attention.cu``), forward and backward, with their launch
counters.

    out = softmax(q . k^T * scale + mask) . v      (scale 1/sqrt(D) unless given)
    q (B,S,H,D), k/v (B,T,K,D) with K | H  ->  (B,S,H,D) in q.dtype

Query i and key j sit at positions i and j; the masks are causal
(i >= j), window (i - j < window) and none.  GQA/MQA: query head h reads
key/value head h // (H // K), with no repeated copy.  Float32 or
bfloat16, D in {32, 64, 112, 128, 256}; any strides with the last dimension
contiguous (bfloat16: 16-byte aligned, strides a multiple of 8, as TMA
reads them).

bfloat16 only: the forward can also return each row's log-sum-exp
``lse`` (f32 (B,H,S)), and ``normalize_first`` runs the instance that
rounds p = exp(s - lse) to bf16 before P V, as the materialised softmax
does (``attention_full(impl="naive")``), in place of the online form.
:func:`flash_attention_bwd` is the backward from (q, k, v, out, dout, lse),
bfloat16 at D = 64 (``BWD_HEAD_DIMS``): dq, dk, dv in the inputs' types,
the GQA heads summed into each kv head.

A CUDA tensor launches the kernels on the current stream or raises; a CPU
or ``meta`` tensor takes the plain versions (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`), which a trace on ``meta`` counts as
the kernel's work (``work.py``: the kept pairs alone).  The counters
``flash_attention.launches`` and ``flash_attention_bwd.launches`` grow by
one per kernel launch (the backward launches two kernels a call) and by
nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 112, 128, 256)
BWD_HEAD_DIMS = (64,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launch = None
_launch_bwd = None


def _kernel():
    global _launch
    if _launch is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _kernel_bwd():
    global _launch_bwd
    if _launch_bwd is None:
        fn = build.load("flash_attention").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_bwd = fn
    return _launch_bwd


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


def tma_ok(x: torch.Tensor) -> bool:
    """TMA can read ``x`` in place: 16-byte aligned, strides a multiple of 8."""
    return x.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def _scaled(x, d, scale):
    """``x`` times the softmax scale: over sqrt(d), or times ``scale``."""
    return x / math.sqrt(d) if scale is None else x * scale


def _scores(q, k, causal, window, scale=None):
    """The masked f32 scores (B,K,G,S,T), masked ones -1e30, as the
    materialised softmax forms them."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qq = q.float().reshape(b, s, kh, h // kh, d)
    sc = _scaled(torch.einsum("bskgd,btkd->bkgst", qq, k.float()), d, scale)
    rel = (torch.arange(s, device=q.device)[:, None]
           - torch.arange(t, device=q.device)[None, :])
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rel >= 0)
    if window is not None:
        mask = mask & (rel < window)
    return torch.where(mask, sc, torch.full_like(sc, -1e30)), mask


def flash_attention_plain(q, k, v, causal, window, with_lse: bool = False, scale=None):
    """The plain version in model layout: what a CPU tensor runs.  With
    ``with_lse`` also each row's log-sum-exp, f32 (B,H,S)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh

    def heads(x, n):   # (B,N,heads,D) -> (B*H,N,D), kv heads repeated
        if x.shape[2] != h:
            x = x.repeat_interleave(g, dim=2)
        return x.movedim(2, 1).reshape(b * h, n, d)

    out = flash_attention_ref(heads(q, s), heads(k, t), heads(v, t),
                              causal=causal, window=window, scale=scale)
    out = out.reshape(b, h, s, d).movedim(1, 2)
    if not with_lse:
        return out
    sc, _ = _scores(q, k, causal, window, scale)
    return out, torch.logsumexp(sc, dim=-1).reshape(b, h, s)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, window,
                              ds_dtype: Optional[torch.dtype] = None, scale=None):
    """The backward's plain version: what a CPU tensor runs.  P is
    recomputed from ``lse`` in f32; dV from P rounded to v's type (the
    rounding of the forward's P V), dP, dS, dQ and dK in f32; the GQA
    heads of a kv head summed into its dK and dV.  Returns (dq, dk, dv) in
    the inputs' types.  ``ds_dtype`` rounds dS to that type before dQ and
    dK: the control that a check of the kernel's hi + lo split of dS must
    tell apart (bf16 dS alone)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    sc, mask = _scores(q, k, causal, window, scale)
    p = torch.where(mask, torch.exp(sc - lse.float().reshape(b, kh, g, s, 1)),
                    torch.zeros_like(sc))
    do = dout.float().reshape(b, s, kh, g, d)
    dv = torch.einsum("bkgst,bskgd->btkd", p.to(v.dtype).float(), do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    delta = (do * out.float().reshape(b, s, kh, g, d)).sum(-1)      # (B,S,K,G)
    ds = _scaled(p * (dp - delta.permute(0, 2, 3, 1)[..., None]), d, scale)
    if ds_dtype is not None:
        ds = ds.to(ds_dtype).float()
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()).reshape(b, s, h, d)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.float().reshape(b, s, kh, g, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _softmax_scale(d: int, scale: Optional[float]) -> float:
    """The kernels' ``scale`` argument: 1/sqrt(D) unless one is given."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _check_cuda(q, k, v) -> None:
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {d}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the head dimension contiguous")
    if b * h > 65535:
        raise ValueError(f"flash_attention takes B*H <= 65535, got {b * h}")
    if q.dtype == torch.bfloat16 and not all(tma_ok(x) for x in (q, k, v)):
        raise ValueError("bfloat16 flash_attention loads by TMA: q, k, v need "
                         "16-byte aligned data and strides a multiple of 8")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int] = None,
                    normalize_first: bool = False, return_lse: bool = False,
                    scale: Optional[float] = None):
    """The forward; with ``return_lse`` returns (out, lse).  ``scale``: the
    softmax scale (None: 1/sqrt(D))."""
    _check(q, k, v, window)
    if q.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.flash_attention(q, k, v, causal, window)):
            return flash_attention_plain(q, k, v, causal, window, with_lse=return_lse,
                                         scale=scale)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    _check_cuda(q, k, v)
    if (normalize_first or return_lse) and q.dtype != torch.bfloat16:
        raise TypeError("flash_attention's lse and normalise-first instance are bfloat16 only")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if s == 0:
        return (out, lse) if return_lse else out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, s, t, h, kh, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(bool(causal)), 0 if window is None else int(window),
                _softmax_scale(d, scale), None if lse is None else lse.data_ptr(),
                int(bool(normalize_first)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of the forward's ``out`` = attention(q, k, v), given
    the gradient ``dout`` of ``out`` and the forward's ``lse``; ``scale``
    the forward's."""
    _check(q, k, v, window)
    b, s, h, d = q.shape
    t = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} against q "
                         f"{tuple(q.shape)}")
    if q.device.type in ("cpu", "meta"):
        with work.counted(*work.flash_attention_bwd(q, k, v, causal, window)):
            return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal, window,
                                             scale=scale)
    _check_cuda(q, k, v)
    if q.dtype != torch.bfloat16 or d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd takes bfloat16 at head_dim in "
                         f"{BWD_HEAD_DIMS}, got {q.dtype} at {d}")
    if window is not None and s - t >= window:
        raise ValueError("flash_attention_bwd: a query row sees no key "
                         f"(S {s} - T {t} >= window {window})")
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    if not (tma_ok(dout) and out.data_ptr() % 16 == 0):
        raise ValueError("flash_attention_bwd needs out and dout 16-byte aligned")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if s == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, s, t, h, k.shape[2], d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(bool(causal)), 0 if window is None else int(window),
                _softmax_scale(d, scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 2            # dQ (with Delta), then dK/dV
    return dq, dk, dv


flash_attention_bwd.launches = 0
