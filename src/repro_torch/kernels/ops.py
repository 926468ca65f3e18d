"""Differentiable wrapper around the fused base+LoRA kernel — the port of
``src/repro/kernels/ops.py: fused_lora_matmul`` and its custom VJP.

Forward is the kernel.  The backward computes ``dx = g @ W^T + s*(g @ B) @ A``
with the SAME kernel on (g, W^T, B^T, A^T) — the down/up projections swap
roles — and ``dA = s*(g @ B)^T @ x``, ``dB = s*g^T @ (x @ A^T)`` as plain
products, as the reference does.  ``dW`` and ``dx`` are formed only when
autograd asks for them: the base weights are frozen in split-federated
fine-tuning, so ``dW`` never is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lora_matmul import lora_matmul


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
            dx = lora_matmul(g, w.t().contiguous(), b.t().contiguous(),
                             a.t().contiguous(), scale=s)
        if ctx.needs_input_grad[1]:
            dw = x2.t() @ g
        if ctx.needs_input_grad[2]:
            da = s * ((g @ b).t() @ x2)                   # (r, K)
        if ctx.needs_input_grad[3]:
            db = s * (g.t() @ (x2 @ a.t()))               # (N, r)
        return dx, dw, da, db, None


def fused_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, scale: float) -> torch.Tensor:
    """y = x @ w + scale*(x@a.T)@b.T for x of shape (..., K)."""
    *lead, kdim = x.shape
    y = _FusedLoRAMatmul.apply(x.reshape(-1, kdim).contiguous(), w,
                               a.contiguous(), b.contiguous(), float(scale))
    return y.reshape(*lead, w.shape[1])
