"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each kernel against on the card.
Mirrors ``src/repro/kernels/ref.py``."""
from __future__ import annotations

import torch


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float) -> torch.Tensor:
    """y = x @ w + scale * (x @ a.T) @ b.T.

    x: (M, K); w: (K, N); a: (r, K); b: (N, r).  f32 accumulation.
    """
    xf = x.float()
    y = xf @ w.float()
    lo = xf @ a.float().t()
    y = y + scale * (lo @ b.float().t())
    return y.to(x.dtype)
