"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and what ``chip_smoke.py`` holds each kernel against on the card.
Mirrors ``src/repro/kernels/ref.py``."""
from __future__ import annotations

import math

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


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor):
    """RWKV6 WKV recurrence, one time step after the other, in f32.

    r/k/v/w: (B, S, H, D); u: (H, D); state: (B, H, D, D).
      out_t = r_t . (S_{t-1} + u*k_t (x) v_t)
      S_t   = diag(w_t) S_{t-1} + k_t (x) v_t
    Returns (out (B,S,H,D) f32, final state).
    """
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    s = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B,H,D,D)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None, scale=None) -> torch.Tensor:
    """What the flash kernel computes, with materialized probabilities.
    q/k/v: (BH, S|T, D), keys already expanded to the query heads; query i
    and key j sit at positions i and j; the scores times ``scale`` (None:
    over sqrt(D)).  Output in q.dtype."""
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float())
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    rel = (torch.arange(s, device=q.device)[:, None]
           - torch.arange(t, device=q.device)[None, :])
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rel >= 0)
    if window is not None:
        mask = mask & (rel < window)
    scores = torch.where(mask[None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bst,btd->bsd", probs.to(v.dtype), v).to(q.dtype)
