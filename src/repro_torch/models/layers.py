"""Shared neural-net primitives: norms, RoPE, LoRA-aware projections,
attention (GQA/MQA, qkv biases, sliding window, KV-cache decode), MLPs,
cross-entropy.
Port of ``src/repro/models/layers.py``.

Pure functions over explicit parameter trees (dicts of tensors).  Weights
keep the JAX package's (in, out) layout, so ``x @ w`` applies them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# init helpers (explicit generator and device)
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen: torch.Generator, shape, device) -> Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (_normal(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> Tensor:
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm with the population variance, computed in f32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm computed in f32 with the (1 + weight) scale (weight starts
    at zero)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def apply_norm(cfg: ModelConfig, p: dict, x: Tensor) -> Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def group_norm(x: Tensor, weight: Tensor, bias: Tensor, n_groups: int,
               eps: float = 1e-5) -> Tensor:
    """GroupNorm over the last dim split into n_groups (rwkv ln_x)."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (x * weight + bias).to(dt)


# ---------------------------------------------------------------------------
# LoRA-aware projection
# ---------------------------------------------------------------------------

# how adapted projections execute (LoRAConfig.impl; the federated engine
# sets it via EngineConfig.fused_lora):
#   einsum — plain PyTorch products (the reference's default);
#   fused  — the hand-written CUDA kernels (kernels/lora_matmul.py, and
#            kernels/grouped_lora.py for cohort-grouped adapters), whose
#            wrappers take the plain version for CPU tensors.
LORA_IMPLS = ("einsum", "fused")


def _lora_apply_grouped(x: Tensor, w: Tensor, lora: dict, scale: float,
                        bias: Optional[Tensor], impl: str) -> Tensor:
    """Cohort-grouped adapters: a (G, r, K), b (G, N, r) against a shared
    base w (K, N).  x's leading axes flatten into G equal row segments
    (segment g owns adapter g) — the ragged server step arranges this.
    ``bias`` is added last, in the output's type, as the reference does."""
    a, b = lora["a"], lora["b"]
    g = a.shape[0]
    *lead, kdim = x.shape
    x2 = x.reshape(-1, kdim)
    m = x2.shape[0]
    if m % g:
        raise ValueError(f"grouped lora_apply: {m} rows are not divisible "
                         f"into G={g} equal segments")
    if impl == "fused":
        from repro_torch.kernels.ops import grouped_lora_matmul
        y2 = grouped_lora_matmul(x2.to(w.dtype), w, a.to(w.dtype), b.to(w.dtype),
                                 group_sizes=(m // g,) * g, scale=float(scale))
        y = y2.reshape(*lead, w.shape[1]).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
        xg = x2.reshape(g, m // g, kdim)
        lo = torch.einsum("gmi,gri->gmr", xg, a.to(x.dtype))
        up = torch.einsum("gmr,gor->gmo", lo, b.to(x.dtype))
        y = y + scale * up.reshape(*lead, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def lora_apply(x: Tensor, w: Tensor, lora: Optional[dict], scale: float,
               bias: Optional[Tensor] = None, impl: Optional[str] = None) -> Tensor:
    """y = x @ w [+ bias] + scale * (x @ a.T) @ b.T   with a:(r,in), b:(out,r).

    A 3-D adapter (G, r, in) / (G, out, r) is a cohort-grouped stack: x's
    rows split into G equal segments, each with its own adapter
    (:func:`_lora_apply_grouped`).  The bias goes in where the reference
    adds it: after the fused kernel, in w's type before the cast to x's;
    on the plain path in x's type, before the adapter term."""
    if impl is None:
        impl = "einsum"
    elif impl not in LORA_IMPLS:
        raise KeyError(f"unknown lora impl {impl!r}; choose from {LORA_IMPLS}")
    if lora is not None and lora["a"].dim() == 3 and w.dim() == 2:
        return _lora_apply_grouped(x, w, lora, scale, bias, impl)
    if impl == "fused" and lora is not None and w.dim() == 2:
        from repro_torch.kernels.ops import fused_lora_matmul
        y = fused_lora_matmul(x.to(w.dtype), w, lora["a"].to(w.dtype),
                              lora["b"].to(w.dtype), scale=float(scale))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.to(x.dtype)
    y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if lora is not None:
        lo = x @ lora["a"].to(x.dtype).t()
        y = y + scale * (lo @ lora["b"].to(x.dtype).t())
    return y


def lora_init(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              device) -> dict:
    """A ~ N(0, 1/r), B = 0 (standard LoRA init: Delta W = BA starts at zero)."""
    return {"a": _normal(gen, (rank, d_in), device) / math.sqrt(rank),
            "b": torch.zeros((d_out, rank), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, Dh); positions: (..., S) or (S,).  Rotates the two
    halves of the head dimension (not interleaved pairs), in f32."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                   # (Dh/2,)
    ang = positions[..., None].float() * inv                # (..., S, Dh/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# how full-sequence attention executes (ModelConfig.attn_impl):
#   naive   — materialized probabilities, plain PyTorch (the reference's
#             default); on the card, inside the kernel pair's domain
#             (:func:`_flash_domain`), the flash kernels' normalise-first
#             instance and their backward, which round where it rounds;
#   chunked — online softmax over key chunks: the hand-written flash kernel
#             (kernels/flash_attention.py, whose wrapper takes the plain
#             version for CPU tensors) where its domain allows, with its
#             backward kernel inside the pair's domain, else the
#             reference's plain chunked form (:func:`_attention_chunked`).
ATTN_IMPLS = ("naive", "chunked")


def _gqa_scores_softmax_out(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                            scale: Optional[float] = None) -> Tensor:
    """q: (B,S,K,G,Dh)  k,v: (B,T,K,Dh)  mask: broadcastable to (B,K,G,S,T);
    the scores times ``scale`` (None: over sqrt(Dh))."""
    dh = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = scores / math.sqrt(dh) if scale is None else scores * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def _is_arange(pos: Tensor, n: int) -> bool:
    return (pos.dim() == 1 and pos.numel() == n
            and torch.equal(pos, torch.arange(n, dtype=pos.dtype, device=pos.device)))


def needs_grad(*tensors: Tensor) -> bool:
    """Autograd will ask for a gradient through these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _flash_domain(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                  window: Optional[int], arange: bool, impl: str) -> Optional[str]:
    """Where the flash kernels take this attention, decided before any
    launch: "pair", "forward" or None (the plain forms of ``impl``).

    "pair" (both impls): CUDA bf16 tensors TMA can read in place; a
    head_dim the backward kernel has (``BWD_HEAD_DIMS``), or no gradient
    asked for and one the forward has; positions the model built as an
    arange (``arange``: nothing is read back from the card); and no query
    row that sees no key (no window, or one of at least S - T + 1).
    "forward" (``impl="chunked"`` alone): outside the pair, no gradient
    asked for and queries and keys at positions 0..S-1 and 0..T-1, where
    the kernel places them (read back from the device unless ``arange``);
    a CPU tensor runs the kernel's plain version there."""
    from repro_torch.kernels import flash_attention as fa
    s, t, d = q.shape[1], k.shape[1], q.shape[3]
    shaped = arange and q_pos.shape == (s,) and k_pos.shape == (t,)
    grad = needs_grad(q, k, v)
    if (shaped and q.is_cuda and all(x.dtype == torch.bfloat16 for x in (q, k, v))
            and s > 0 and t > 0 and (window is None or s - t < window)
            and all(fa.tma_ok(x) and x.stride(3) == 1 for x in (q, k, v))
            and d in (fa.BWD_HEAD_DIMS if grad else fa.HEAD_DIMS)):
        return "pair"
    if grad or impl != "chunked":
        return None
    if shaped or (_is_arange(q_pos, s) and _is_arange(k_pos, t)):
        return "forward"
    return None


def attention_full(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: Optional[int], q_pos: Tensor, k_pos: Tensor,
                   impl: str = "naive", arange: bool = False,
                   chunk: int = 1024, scale: Optional[float] = None) -> Tensor:
    """Full-sequence attention. q:(B,S,H,Dh) k,v:(B,T,K,Dh) -> (B,S,H*Dh);
    the softmax over the scores times ``scale`` (None: 1/sqrt(Dh); a
    config's ``attention_multiplier``), on every path below.

    Where :func:`_flash_domain` says "pair" (on the card, bf16, arange
    positions) both impls run the flash kernels, forward and backward:
    "naive" the normalise-first instance, "chunked" the online one; where
    it says "forward", "chunked" runs the forward kernel, with its own key
    tiles.  Elsewhere:
    impl="naive": materialized (B,K,G,S,T) probabilities.
    impl="chunked": the reference's plain online softmax
    (:func:`_attention_chunked`) over ``chunk``-key chunks, differentiable
    and at any positions."""
    if impl not in ATTN_IMPLS:
        raise KeyError(f"unknown attention impl {impl!r}; choose from {ATTN_IMPLS}")
    if _flash_domain(q, k, v, q_pos, k_pos, window, arange, impl) is not None:
        from repro_torch.kernels.ops import flash_attention_apply
        return flash_attention_apply(q, k, v, causal=causal, window=window,
                                     normalize_first=impl == "naive", scale=scale)
    if impl == "chunked":
        return _attention_chunked(q, k, v, causal=causal, window=window,
                                  q_pos=q_pos, k_pos=k_pos, chunk=chunk, scale=scale)
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    q = q.reshape(b, s, kheads, h // kheads, dh)
    rel = q_pos[:, None] - k_pos[None, :]                        # (S, T)
    if causal:
        mask = rel >= 0
    else:
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if window is not None:
        mask = mask & (rel < window)
    out = _gqa_scores_softmax_out(q, k, v, mask, scale)
    return out.reshape(b, s, h * dh)


def _attention_chunked(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                       window: Optional[int], q_pos: Tensor, k_pos: Tensor,
                       chunk: int, scale: Optional[float] = None) -> Tensor:
    """Online-softmax attention over ``chunk``-key chunks in plain PyTorch
    (the reference's pure-JAX flash), f32 running max, sum and output; keys
    past T are padded at position -1 and masked."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    g = h // kheads
    t = k.shape[1]
    qq = q.reshape(b, s, kheads, g, dh).float()
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    pad = (-t) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), -1, dtype=k_pos.dtype,
                                             device=k_pos.device)])
    f32 = torch.float32
    m = torch.full((b, kheads, g, s), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, kheads, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, kheads, g, s, dh), dtype=f32, device=q.device)
    for c0 in range(0, t + pad, chunk):
        kc, vc, kpc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], k_pos[c0:c0 + chunk]
        sc = torch.einsum("bskgd,btkd->bkgst", qq, kc.float()) * scale
        rel = q_pos[:, None] - kpc[None, :]                       # (S, C)
        mask = kpc[None, :] >= 0
        if causal:
            mask = mask & (rel >= 0)
        if window is not None:
            mask = mask & (rel < window)
        sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), vc)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    # (B,K,G,S,Dh) -> (B,S,K,G,Dh) -> (B,S,H*Dh)
    return out.movedim(3, 1).reshape(b, s, h * dh).to(v.dtype)


def attention_decode(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     valid: Tensor, scale: Optional[float] = None) -> Tensor:
    """One-token decode. q:(B,1,H,Dh) caches:(B,T,K,Dh) valid:(T,) or (B,T);
    ``scale`` as in :func:`attention_full`."""
    b, s, h, dh = q.shape
    kheads = k_cache.shape[2]
    q = q.reshape(b, s, kheads, h // kheads, dh)
    mask = valid[None, None, None, None, :] if valid.dim() == 1 \
        else valid[:, None, None, None, :]
    out = _gqa_scores_softmax_out(q, k_cache, v_cache, mask, scale)
    return out.reshape(b, s, h * dh)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p = {"wu": dense_init(gen, d, ff, dt, device),
         "wd": dense_init(gen, ff, d, dt, device)}
    if cfg.activation in ("silu", "geglu"):      # gated
        p["wg"] = dense_init(gen, d, ff, dt, device)
    return p


def _act(cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "relu2":
        return F.relu(x).square()
    raise ValueError(cfg.activation)


def mlp_apply(cfg: ModelConfig, p: dict, lora: Optional[dict], x: Tensor) -> Tensor:
    scale = cfg.lora.alpha / cfg.lora.rank
    impl = cfg.lora.impl
    lget = (lora or {}).get
    up = lora_apply(x, p["wu"], lget("wu"), scale, impl=impl)
    if "wg" in p:
        up = _act(cfg, lora_apply(x, p["wg"], lget("wg"), scale, impl=impl)) * up
    else:
        up = _act(cfg, up)
    return lora_apply(up, p["wd"], lget("wd"), scale, impl=impl)


# ---------------------------------------------------------------------------
# attention block parameters
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """wq, wk, wv, wo (in, out), and with ``qkv_bias`` the f32 biases bq,
    bk, bv, zero at init as in the reference."""
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {"wq": dense_init(gen, d, cfg.attn_dim, dt, device),
         "wk": dense_init(gen, d, cfg.kv_dim, dt, device),
         "wv": dense_init(gen, d, cfg.kv_dim, dt, device),
         "wo": dense_init(gen, cfg.attn_dim, d, dt, device)}
    if cfg.qkv_bias:
        for key, n in (("bq", cfg.attn_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[key] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


def qkv_project(cfg: ModelConfig, p: dict, lora: Optional[dict], x: Tensor,
                positions: Optional[Tensor] = None):
    scale = cfg.lora.alpha / cfg.lora.rank
    impl = cfg.lora.impl
    lget = (lora or {}).get
    b, s, _ = x.shape
    q = lora_apply(x, p["wq"], lget("wq"), scale, p.get("bq"), impl=impl)
    k = lora_apply(x, p["wk"], lget("wk"), scale, p.get("bk"), impl=impl)
    v = lora_apply(x, p["wv"], lget("wv"), scale, p.get("bv"), impl=impl)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.positional == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg: ModelConfig, p: dict, lora: Optional[dict], ctx: Tensor) -> Tensor:
    scale = cfg.lora.alpha / cfg.lora.rank
    return lora_apply(ctx, p["wo"], (lora or {}).get("wo"), scale,
                      impl=cfg.lora.impl)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: Tensor, targets: Tensor, ignore_id: int = -1) -> Tensor:
    """Mean token cross-entropy; targets == ignore_id are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (targets != ignore_id).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
