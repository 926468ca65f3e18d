"""The precisions the reference computes in.

``fp32`` is the reference itself: float32 products with TF32 off (the
caller sets the backends' flags).  The lower ones are the controls, one
step below what a configuration states: ``tf32`` rounds both operands of
every product, forward and backward, to TF32's 10-bit mantissa, as the
tensor cores do before they multiply and add in float32; ``fp8`` scales
each operand by its absolute maximum into float8 e4m3, rounds it there and
scales it back.  Both are emulated in float32, so they run alike on the
CPU and the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through per-tensor scaled float8 e4m3 and back."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


_ROUND = {"tf32": round_tf32, "fp8": round_fp8}


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    while t.dim() > len(shape):
        t = t.sum(0)
    return t


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with every operand of the forward's and the backward's
    products rounded (b is (k, n) or shares a's leading axes)."""

    @staticmethod
    def forward(ctx, a, b, name):
        rnd = _ROUND[name]
        qa, qb = rnd(a), rnd(b)
        ctx.save_for_backward(qa, qb)
        ctx.name = name
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _ROUND[ctx.name](g)
        ga = qg @ qb.transpose(-1, -2)
        gb = _sum_to(qa.transpose(-1, -2) @ qg, qb.shape)
        return ga, gb, None


class Precision:
    """Every product of the reference goes through :meth:`mm`."""

    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise KeyError(f"unknown precision {name!r}; choose from {PRECISIONS}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.name == "fp32":
            return a @ b
        return _RoundedMatmul.apply(a, b, self.name)
