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


def grouped_lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, group_sizes,
                            scales) -> torch.Tensor:
    """y_i = x_i @ w + s_i * (x_i @ a_i.T) @ b_i.T over a ragged concat batch.

    x: (sum(group_sizes), K), the groups' rows concatenated in order;
    w: (K, N) shared; a: (G, r, K), b: (G, N, r) per-group adapters;
    scales: length G.  f32 accumulation, per group via
    :func:`lora_matmul_ref`.
    """
    outs, off = [], 0
    for i, mg in enumerate(group_sizes):
        mg = int(mg)
        outs.append(lora_matmul_ref(x[off:off + mg], w, a[i], b[i],
                                    float(scales[i])))
        off += mg
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def quantize_rows_ref(x: torch.Tensor):
    """Per-row symmetric int8 over the last axis of a 2-D ``x``:
    ``scale = max(absmax / 127, 1e-12)`` and
    ``q = clip(round(x / scale), -127, 127)``, with ``torch.round``
    rounding half to even as ``jnp.round`` does.  Returns (q int8 (N, d),
    scale f32 (N,)).

    Both divisions are elementwise between tensors: PyTorch's CUDA kernels
    divide by a Python scalar as a product with its reciprocal, which can
    land an ulp away from the IEEE quotient that the reference's
    ``comm.quantize`` and the kernel compute."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]
