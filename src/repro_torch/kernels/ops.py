"""Model-layout wrappers around the port's kernels — the port of
``src/repro/kernels/ops.py``: ``fused_lora_matmul`` and
``grouped_lora_matmul`` with their custom VJPs, ``flash_attention_apply``
(the flash forward and, where a gradient is asked for, its backward
kernel) and the forward-only ``wkv6_apply``.

Forward is the kernel, in float32 or bfloat16.  The backward computes
``dx = g @ W^T + s*(g @ B) @ A`` with the SAME kernel on (g, W^T, B^T, A^T)
— the down/up projections swap roles — in the input's type, and
``dA = s*(g @ B)^T @ x``, ``dB = s*g^T @ (x @ A^T)`` as plain products of
f32 upcasts cast to each parameter's type, as the reference does (in
float32 the upcasts are the tensors themselves).  ``dW`` and ``dx`` are formed only when
autograd asks for them: the base weights are frozen in split-federated
fine-tuning, so ``dW`` never is.  The grouped op does the same per group:
``dx`` through the grouped kernel on (g, W^T, B_i^T, A_i^T), ``dA_i`` and
``dB_i`` as plain products over each group's rows.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.grouped_lora import grouped_lora
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.wkv6 import wkv6

# mode="auto" of the grouped op takes the single-stage direct form when the
# contraction fits one of the reference's 128-wide K blocks
DIRECT_AUTO_K = 128


class _FusedLoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, a, b, scale: float):
        ctx.save_for_backward(x2, w, a, b)
        ctx.scale = scale
        return lora_matmul(x2, w, a, b, scale=scale)

    @staticmethod
    def backward(ctx, g):
        x2, w, a, b = ctx.saved_tensors
        s = ctx.scale
        g = g.contiguous()
        dx = dw = da = db = None
        if ctx.needs_input_grad[0]:
            # views: the kernel reads W^T K-contiguous and B^T, A^T by strides
            dx = lora_matmul(g, w.t(), b.t(), a.t(), scale=s).to(x2.dtype)
        gf, xf = g.float(), x2.float()
        if ctx.needs_input_grad[1]:
            dw = (xf.t() @ gf).to(w.dtype)
        if ctx.needs_input_grad[2]:
            da = (s * ((gf @ b.float()).t() @ xf)).to(a.dtype)            # (r, K)
        if ctx.needs_input_grad[3]:
            db = (s * (gf.t() @ (xf @ a.float().t()))).to(b.dtype)        # (N, r)
        return dx, dw, da, db, None


def fused_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, scale: float) -> torch.Tensor:
    """y = x @ w + scale*(x@a.T)@b.T for x of shape (..., K)."""
    *lead, kdim = x.shape
    y = _FusedLoRAMatmul.apply(x.reshape(-1, kdim).contiguous(), w,
                               a.contiguous(), b.contiguous(), float(scale))
    return y.reshape(*lead, w.shape[1])


def _grouped_mode(mode: str, kdim: int) -> str:
    if mode == "auto":
        return "direct" if kdim <= DIRECT_AUTO_K else "chunk"
    return mode


class _GroupedLoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, a, b, group_sizes, scales, mode):
        ctx.save_for_backward(x2, w, a, b)
        ctx.group_sizes, ctx.scales, ctx.mode = group_sizes, scales, mode
        return grouped_lora(x2, w, a, b, group_sizes=group_sizes, scales=scales,
                            mode=_grouped_mode(mode, x2.shape[1]))

    @staticmethod
    def backward(ctx, g):
        x2, w, a, b = ctx.saved_tensors
        sizes, scales = ctx.group_sizes, ctx.scales
        g = g.contiguous()
        dx = dw = da = db = None
        if ctx.needs_input_grad[0]:
            # the (G, r, N) down- and (G, K, r) up-projections swap roles;
            # views: the kernel reads W^T K-contiguous and B_i^T, A_i^T by strides
            dx = grouped_lora(g, w.t(), b.transpose(1, 2), a.transpose(1, 2),
                              group_sizes=sizes, scales=scales,
                              mode=_grouped_mode(ctx.mode, g.shape[1])).to(x2.dtype)
        gf, xf = g.float(), x2.float()
        if ctx.needs_input_grad[1]:
            dw = (xf.t() @ gf).to(w.dtype)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            offs = [0, *itertools.accumulate(sizes)]
            af, bf = a.float(), b.float()
            das, dbs = [], []
            for i, s in enumerate(scales):
                xg, gg = xf[offs[i]:offs[i + 1]], gf[offs[i]:offs[i + 1]]
                das.append(s * ((gg @ bf[i]).t() @ xg))           # (r, K)
                dbs.append(s * (gg.t() @ (xg @ af[i].t())))       # (N, r)
            da = torch.stack(das).to(a.dtype) if ctx.needs_input_grad[2] else None
            db = torch.stack(dbs).to(b.dtype) if ctx.needs_input_grad[3] else None
        return dx, dw, da, db, None, None, None


def grouped_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, *, group_sizes: Sequence[int],
                        scale: Optional[float] = None,
                        scales: Optional[Sequence[float]] = None,
                        mode: str = "auto") -> torch.Tensor:
    """y_i = x_i @ w + s_i * (x_i @ a_i.T) @ b_i.T — one launch per cohort.

    x: (sum(group_sizes), K), the cohort's rows concatenated group by group;
    w: (K, N) shared frozen base; a: (G, r, K) / b: (G, N, r) per-group
    adapters.  Pass one ``scale`` for a uniform cohort or per-group
    ``scales``.  mode="auto" takes "direct" when K <= 128, else "chunk".
    Differentiable with respect to x, w, a and b; all float32 or all
    bfloat16, y in x's type.
    """
    group_sizes = tuple(int(s) for s in group_sizes)
    if not group_sizes or any(s < 1 for s in group_sizes):
        raise ValueError(f"group_sizes must be non-empty positive ints, "
                         f"got {group_sizes}")
    if x.dim() != 2 or x.shape[0] != sum(group_sizes):
        raise ValueError(f"x has shape {tuple(x.shape)}, but group_sizes sum "
                         f"to {sum(group_sizes)} rows")
    if a.shape[0] != len(group_sizes) or b.shape[0] != len(group_sizes):
        raise ValueError("need one (a, b) adapter pair per group")
    if (scales is None) == (scale is None):
        raise ValueError("pass exactly one of scale= / scales=")
    if scales is None:
        scales = (float(scale),) * len(group_sizes)
    else:
        scales = tuple(float(s) for s in scales)
        if len(scales) != len(group_sizes):
            raise ValueError("need one scale per group")
    if mode not in ("auto", "chunk", "direct"):
        raise KeyError(f"unknown grouped-lora mode {mode!r}; "
                       "choose from ('auto', 'chunk', 'direct')")
    return _GroupedLoRAMatmul.apply(x.contiguous(), w.contiguous(), a.contiguous(),
                                    b.contiguous(), group_sizes, scales, mode)


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    """The WKV6 kernel has no backward, as the reference's has no VJP: a
    CUDA tensor that asks for a gradient raises rather than leaving
    autograd without a path.  The models never get here under grad:
    ``wkv_impl="chunked"`` takes the plain chunked form there
    (``blocks.wkv_apply``)."""
    if torch.is_grad_enabled() and any(t.is_cuda and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only, as the reference's kernel has no VJP; "
            "differentiate the plain chunked form instead")


class _FlashAttention(torch.autograd.Function):
    """The flash forward, which also returns each row's log-sum-exp, and the
    backward kernel pair.  Saves q, k, v, the output and lse alone: the
    backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, normalize_first: bool):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   normalize_first=normalize_first, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          normalize_first: bool = False) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,K,D) with K | H  ->  (B,S,H*D) in q.dtype.
    GQA reads the shared kv head in the kernel; nothing is repeated, moved
    or padded.  ``normalize_first``: the instance that rounds the
    normalised probabilities to bf16 before P V (``impl="naive"``).
    Differentiable: where a gradient is asked for, the forward saves its
    lse and the backward runs :func:`flash_attention_bwd` (on the card
    bfloat16 at ``BWD_HEAD_DIMS`` only: other CUDA inputs raise here, before
    any launch)."""
    b, s, h, d = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.is_cuda and (q.dtype != torch.bfloat16 or d not in BWD_HEAD_DIMS):
            raise NotImplementedError(
                f"flash_attention_apply has a backward kernel for bfloat16 at head_dim "
                f"in {BWD_HEAD_DIMS}, not {q.dtype} at {d}; differentiate the plain "
                "forms instead")
        out = _FlashAttention.apply(q, k, v, causal, window, normalize_first)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              normalize_first=normalize_first)
    return out.reshape(b, s, h * d)


def wkv6_apply(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor):
    """r/k/v/w (B,S,H,D), u (H,D): the WKV recurrence from a zero state.
    Returns (out (B,S,H,D) in r.dtype, final state (B,H,D,D) f32)."""
    _forward_only("wkv6_apply", r, k, v, w, u)
    return wkv6(r, k, v, w, u.float())
