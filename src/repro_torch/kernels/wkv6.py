"""ctypes binding of the RWKV6 WKV recurrence CUDA kernel
(``csrc/wkv6.cu``), with its launch counter.

    out_t = r_t . (S_{t-1} + u*k_t (x) v_t),  S_t = diag(w_t) S_{t-1} + k_t (x) v_t

from S_0 = 0.  r/k/v (B,T,H,D) float32 or bfloat16, w (B,T,H,D) float32
or r's type, u (H,D); returns (out (B,T,H,D) in r.dtype, final state
(B,H,D,D) float32).  D in {16, 32, 64, 128}; any strides with the last
dimension contiguous, so the model's bf16 r/k/v and f32 decay go in as
they are.

A CUDA tensor launches the kernel on the current stream or raises; a CPU
or ``meta`` tensor takes the plain version (``ref.wkv6_ref``), which a
trace on ``meta`` counts as the kernel's work (``work.py``).  The counter
``wkv6.launches`` grows by one per kernel launch and by nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ref import wkv6_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_launch = None


def _kernel():
    global _launch
    if _launch is None:
        fn = build.load("wkv6").wkv6_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 takes r, k, v, w of one (B,T,H,D) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    if u.shape != r.shape[2:]:
        raise ValueError(f"wkv6 takes u of shape (H, D) = {tuple(r.shape[2:])}, "
                         f"got {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("wkv6 takes float32 or bfloat16 r, k, v of one type")
    if w.dtype not in (torch.float32, r.dtype):
        raise TypeError("wkv6 takes w in float32 or in r's type")
    if u.dtype != torch.float32:
        raise TypeError("wkv6 takes a float32 u")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError("wkv6 inputs must share one device")
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6 runs on cuda, cpu or meta, not {r.device}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(r, k, v, w, u)
    b, t, h, d = r.shape
    if r.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.wkv6(r, k, v, w, u)):
            out, state = wkv6_ref(r, k, v, w, u, torch.zeros(
                (b, h, d, d), dtype=torch.float32, device=r.device))
        return out.to(r.dtype), state
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes head_dim in {HEAD_DIMS}, got {d}")
    if any(x.stride(3) != 1 for x in (r, k, v, w)):
        raise ValueError("wkv6 needs the head dimension contiguous")
    out = torch.empty((b, t, h, d), dtype=r.dtype, device=r.device)
    if b * h == 0 or t == 0:
        return out, torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    u = u.contiguous()
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), out.data_ptr(), state.data_ptr(),
                _DTYPES[r.dtype], _DTYPES[w.dtype], b, t, h, d,
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *w.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    wkv6.launches += 1
    return out, state


wkv6.launches = 0
